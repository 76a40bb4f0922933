"""The train step and the refresh steps, on a single device (port of the
default, fused-apply and anomaly-guarded branches of
repro/distributed/step.py::make_train_step and its ``_grads_and_loss``, and
of the one-device forms of ``make_refresh_step``, ``make_async_refresh_step``
and ``make_swap_step``), and the serving steps: the contiguous-cache prefill
and decode and the paged ones the engine batches (``make_paged_prefill_step``,
``make_paged_decode_step``). The sharded refresh, GaLore-DP compression and
ZeRO are not ported (ROADMAP A.9)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.galore import (
    make_fused_apply,
    refresh_projectors,
    refresh_projectors_pending,
    swap_pending_state,
)
from repro_torch.models import model as M
from repro_torch.optim import schedules
from repro_torch.optim.factory import (
    build_optimizer,
    effective_galore_config,
    external_refresh,
    galore_state_index,
)
from repro_torch.optim.transform import apply_updates, clip_in_place
from repro_torch.robust.guard import global_grad_norm, guard_step
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten_like


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns (train_step(params, opt_state, batch) -> (params, opt_state, metrics), opt).

    train_step updates `params` in place and returns them. With
    tc.anomaly_guard the step is the guarded one (_make_guarded_train_step)."""
    opt = build_optimizer(tc)

    def loss_of(params, batch):
        return M.loss_fn(cfg, params, batch, z_loss=tc.z_loss)

    if tc.anomaly_guard:
        if tc.galore_fused_apply:
            raise ValueError("anomaly_guard wraps the default/chain train step; the "
                             "galore_fused_apply fast path has no guarded variant yet")
        return _make_guarded_train_step(tc, opt, loss_of), opt

    if tc.galore_fused_apply:
        if tc.microbatch and tc.microbatch > 1:
            raise ValueError("galore_fused_apply does not compose with gradient accumulation "
                             "yet (microbatch > 1)")
        return _make_fused_apply_train_step(tc, opt, loss_of), opt

    def train_step(params, opt_state, batch):
        _, metrics, grads = _grads_and_loss(tc, loss_of, params, batch)
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, metrics

    return train_step, opt


def _make_guarded_train_step(tc, opt, loss_of):
    """The anomaly-guarded step (tc.anomaly_guard, robust/):

        train_step(params, opt_state, guard, batch[, fault])
            -> (params', opt_state', guard', metrics)

    After the unchanged loss and gradient, the guard checks the loss and the
    global grad norm for finiteness and the loss for a z-score spike. The
    reference branches on its verdict inside the program (``lax.cond``); the
    port reads it on the host before any optimizer call — one device→host
    sync a step, between the backward and the optimizer — because the GaLore
    kernels update moments (and W) in place. A rejected step calls nothing
    of the optimizer, so params, moments, projectors, the schedule's count
    and the galore step stay exactly as they were. Metrics gain "guard_ok"
    (this step's verdict, int32) and "guard_skips" (the running total).
    With tc.fault_hooks the fault scalars ({"loss_add", "grad_scale"},
    robust/faults.py) perturb the loss value and scale every gradient."""
    use_faults = bool(tc.fault_hooks)

    def train_step(params, opt_state, guard, batch, fault=None):
        loss, metrics, grads = _grads_and_loss(tc, loss_of, params, batch)
        if use_faults and fault is not None:
            loss = loss + fault["loss_add"]
            grads = tree_map(lambda g: g * fault["grad_scale"].to(g.dtype), grads)
        ok, guard = guard_step(guard, loss, global_grad_norm(grads), zmax=tc.guard_zmax,
                               warmup=tc.guard_warmup, ema=tc.guard_ema)
        if bool(ok):  # the guarded step's one host read
            with torch.no_grad():
                updates, opt_state = opt.update(grads, opt_state, params)
                params = apply_updates(params, updates)
        metrics = dict(metrics, loss=loss, guard_ok=ok.to(torch.int32),
                       guard_skips=guard["skips"])
        return params, opt_state, guard, metrics

    return train_step


def _make_fused_apply_train_step(tc, opt, loss_of):
    """The W-in-place step (tc.galore_fused_apply): clip (in place in the
    step's own gradients) → one fused kernel per GaLore leaf that folds projection, Adam, back-projection and the weight
    update W ← W + η·(G̃ + wd·W) into one launch, so no full-size f32 update
    tree is made. The optimizer state keeps the chain's layout (clip, galore,
    [wd], schedule), so states swap freely with the emit path, which stays
    the numerics oracle."""
    gcfg = effective_galore_config(tc)
    if gcfg is None:
        raise ValueError("galore_fused_apply requires a GaLore config")
    idx = galore_state_index(tc)
    sched = schedules.warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps)
    wd = tc.weight_decay if tc.optimizer == "adamw" else 0.0
    apply_fn = make_fused_apply(gcfg, b1=tc.b1, b2=tc.b2, eps=tc.eps, weight_decay=wd,
                                external_refresh=external_refresh(tc))

    def train_step(params, opt_state, batch):
        _, metrics, grads = _grads_and_loss(tc, loss_of, params, batch)
        with torch.no_grad():
            if tc.grad_clip > 0:  # the chain's own clip, so the two paths clip alike
                grads = clip_in_place(grads, tc.grad_clip)
            count = opt_state[-1]["count"] + 1
            eta = -sched(count)  # stays on the device: no step syncs the host
            params, galore_state = apply_fn(params, grads, opt_state[idx], eta)
        opt_state = (opt_state[:idx] + (galore_state,) + opt_state[idx + 1:-1]
                     + ({"count": count},))
        return params, opt_state, metrics

    return train_step


def _grads_and_loss(tc, loss_of, params, batch):
    """(loss, metrics, grads); with tc.microbatch > 1 the batch is split and
    the f32 gradients averaged, as the reference's scan does."""
    leaves = tree_leaves(params)
    if tc.microbatch and tc.microbatch > 1:
        nm = tc.microbatch
        chunks = [{k: v.chunk(nm, dim=0)[i] for k, v in batch.items()} for i in range(nm)]
        g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        loss_acc = 0.0
        for b in chunks:
            loss, _ = loss_of(params, b)
            gs = torch.autograd.grad(loss, leaves)
            g_acc = [a + g.float() / nm for a, g in zip(g_acc, gs)]
            loss_acc = loss_acc + loss.detach() / nm
        return loss_acc, {"loss": loss_acc}, tree_unflatten_like(params, g_acc)
    loss, metrics = loss_of(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, tree_unflatten_like(params, list(grads))


def make_refresh_grads(cfg: ModelConfig, tc: TrainConfig):
    """refresh_grads(params, batch) -> grads: the refresh's own gradient, on
    the batch's first microbatch (the whole batch without accumulation), as
    the reference's refresh programs take it; raw, not clipped."""

    def refresh_grads(params, batch):
        if tc.microbatch and tc.microbatch > 1:
            batch = {k: v.chunk(tc.microbatch, dim=0)[0] for k, v in batch.items()}
        loss, _ = M.loss_fn(cfg, params, batch, z_loss=tc.z_loss)
        return tree_unflatten_like(params, list(torch.autograd.grad(loss, tree_leaves(params))))

    return refresh_grads


def make_refresh_step(cfg: ModelConfig, tc: TrainConfig):
    """The external refresh: refresh_step(params, opt_state, batch, step=None)
    -> opt_state, the galore state's projectors (and adaptive schedule)
    refreshed from the gradient of `batch`. step None refreshes every
    projector; a step only the leaves due at it (core/galore.py
    ``refresh_projectors``)."""
    if tc.galore is None:
        raise ValueError("the refresh step needs a GaLore config")
    gcfg = effective_galore_config(tc)
    idx = galore_state_index(tc)
    refresh_grads = make_refresh_grads(cfg, tc)

    def refresh_step(params, opt_state, batch, step=None):
        grads = refresh_grads(params, batch)
        with torch.no_grad():
            g = refresh_projectors(grads, opt_state[idx], gcfg, step=step)
        return opt_state[:idx] + (g,) + opt_state[idx + 1:]

    return refresh_step


def make_async_refresh_step(cfg: ModelConfig, tc: TrainConfig):
    """refresh_pending(params, galore_sub, batch, step=None) -> pending: the
    refresh written into a pending buffer, never the state. `galore_sub` is
    the {"step", "key", "proj"[, "schedule"]} slice of the galore state: the
    moments never enter it. Dueness as make_refresh_step's. The async driver
    (launch/train.py) runs its two halves apart: the gradient on a CUDA
    stream of its own, the refresh on a host thread."""
    if tc.galore is None:
        raise ValueError("the async refresh needs a GaLore config")
    gcfg = effective_galore_config(tc)
    refresh_grads = make_refresh_grads(cfg, tc)

    def refresh_pending(params, sub, batch, step=None):
        grads = refresh_grads(params, batch)
        with torch.no_grad():
            return refresh_projectors_pending(grads, sub, gcfg, step=step)

    return refresh_pending


def make_swap_step(cfg: ModelConfig, tc: TrainConfig):
    """swap(opt_state, pending, params) -> opt_state: the async refresh's
    step boundary, P_next installed on the flagged leaves (with their
    schedule scalars, and under reproject_moments their moments rotated;
    core/subspace.py ``swap_pending``). `params` gives the leaf shapes."""
    if tc.galore is None:
        raise ValueError("the async refresh needs a GaLore config")
    gcfg = effective_galore_config(tc)
    idx = galore_state_index(tc)
    if gcfg.reproject_moments and tc.optimizer not in ("adam", "adamw", "adam8bit"):
        raise ValueError("GaLoreConfig.reproject_moments rotates Adam-shaped {m, v} moments; "
                         f"optimizer {tc.optimizer!r} has no such state")

    def swap_step(opt_state, pending, params):
        with torch.no_grad():
            g = swap_pending_state(params, opt_state[idx], pending, gcfg)
        return opt_state[:idx] + (g,) + opt_state[idx + 1:]

    return swap_step


def make_prefill_step(cfg: ModelConfig):
    """prefill(params, cache, batch) -> (last_logits (B, V), cache): the
    prompt's K/V written at 0 of a contiguous cache (in place)."""

    def prefill_step(params, cache, batch):
        with torch.inference_mode():
            logits, cache = M.forward_cached(cfg, params, batch, cache=cache, cache_pos=0)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, with_logits: bool = False):
    """decode(params, cache, tokens (B, 1), pos) -> (next_tokens (B,), cache):
    one token a row written at `pos` of a contiguous cache, greedy. With
    `with_logits` the step returns (next_tokens, last_logits (B, V), cache)."""

    def decode_step(params, cache, tokens, pos):
        with torch.inference_mode():
            batch = {"tokens": tokens}
            if cfg.rope_style == "mrope":  # text positions: three equal rows
                batch["positions"] = torch.full((3, tokens.shape[0], 1), pos, dtype=torch.int32,
                                                device=tokens.device)
            logits, cache = M.forward_cached(cfg, params, batch, cache=cache, cache_pos=pos)
            last = logits[:, -1]
            next_tok = last.argmax(dim=-1).to(torch.int32)
        return (next_tok, last, cache) if with_logits else (next_tok, cache)

    return decode_step


def _paged_layer_cache(cfg, kv, bt, pos):
    """The per-call paged cache: the stacked pool and this call's block tables
    and positions, given once for every layer (the reference broadcasts them
    to L for its scan; the layer loop slices only the pool)."""
    return {"kp": kv["kp"], "vp": kv["vp"], "bt": bt, "pos": pos}


def _explicit_positions(cfg, pos_2d):
    """Per-row rope positions (B, S) -> batch["positions"] for the forward:
    the positions themselves, or under M-RoPE three equal rows (3, B, S)."""
    if cfg.rope_style == "mrope":
        return pos_2d[None].expand((3,) + tuple(pos_2d.shape))
    return pos_2d


def make_paged_prefill_step(cfg: ModelConfig):
    """paged_prefill(params, kv, bt, pos0, tokens) -> (logits (B, C, V), kv).

    One prefill chunk a lane: tokens (B, C) holds a fixed-width slice of each
    lane's prompt from its own offset pos0 — an int (every lane at one
    offset) or a (B,) tensor — so the engine prefills every pending slot in
    one batched call (lanes pad their last chunk). bt (B, nb) are per-lane
    block tables; K/V go into the pool's blocks in place, and logits come
    back for every chunk position."""

    def prefill_step(params, kv, bt, pos0, tokens):
        B, C = tokens.shape
        with torch.inference_mode():
            pos0 = torch.as_tensor(pos0, dtype=torch.int32, device=tokens.device)
            pos0 = pos0.reshape(-1).expand(B)
            pos_rows = pos0[:, None] + torch.arange(C, dtype=torch.int32, device=tokens.device)
            batch = {"tokens": tokens, "positions": _explicit_positions(cfg, pos_rows)}
            logits, _ = M.forward_cached(cfg, params, batch,
                                         cache=_paged_layer_cache(cfg, kv, bt, pos0))
        return logits, kv

    return prefill_step


def make_paged_decode_step(cfg: ModelConfig):
    """paged_decode(params, kv, bt, pos, tokens) -> (last_logits (B, V), kv).

    One token for every decode lane at once: tokens (B, 1), bt (B, nb), pos
    (B,) — each row's write index and rope position, so lanes at unrelated
    lengths batch into one call. Inactive lanes pass a block-table row of
    zeros and pos 0: their K/V land in scratch block 0 and their logits are
    discarded by the caller. Raw logits, so the engine samples per request."""

    def decode_step(params, kv, bt, pos, tokens):
        with torch.inference_mode():
            batch = {"tokens": tokens, "positions": _explicit_positions(cfg, pos[:, None])}
            logits, _ = M.forward_cached(cfg, params, batch,
                                         cache=_paged_layer_cache(cfg, kv, bt, pos))
        return logits[:, -1], kv

    return decode_step
