"""The train step and the refresh steps, on one device or on each rank of a
data-parallel world (port of repro/distributed/step.py: ``make_train_step``
with its default, fused-apply, guarded and GaLore-DP compressed branches,
``make_refresh_step`` and ``make_async_refresh_step`` with the sharded
refresh, ``make_swap_step``), and the serving steps: the contiguous-cache
prefill and decode and the paged ones the engine batches
(``make_paged_prefill_step``, ``make_paged_decode_step``).

Data parallel (distributed/world.py): every rank is handed the global batch
and runs forward and backward on its own rows (``world.shard_batch``); the
gradients are averaged over the world in f32 and cast back to their dtype
before the clip, so the clip and the guard see the global gradient, and the
loss is averaged for the metrics and the guard (whose verdict, read after
the collective, is every rank's). With no world the steps are the
one-device ones. GaLore-DP (``galore_dp_compress``) projects each rank's own
gradient and averages the compact R: with no world it takes the reference's
two virtual shards of the batch, so one process computes what the
reference's CPU step computes; under ZeRO-2 the average is a reduce-scatter
onto the owners' rank blocks. ``galore_refresh_shard`` bin-packs the due
SVD units over the ranks (``SubspaceManager.partition_refresh``), each rank
computes its own and the owners' P is summed onto every rank.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.galore import (
    make_fused_apply,
    refresh_projectors,
    refresh_projectors_pending,
    swap_pending_state,
)
from repro_torch.core.projector import read_projector
from repro_torch.core.subspace import SubspaceManager, proj_shape, sum_units
from repro_torch.distributed import world
from repro_torch.distributed.state_sharding import ZeroLayout
from repro_torch.kernels import ref
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
from repro_torch.utils import flatten_up_to, tree_leaves, tree_map, tree_unflatten_like


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns (train_step(params, opt_state, batch) -> (params, opt_state, metrics), opt).

    train_step updates `params` in place and returns them; `batch` is the
    global batch (each rank of a world runs its own rows). With
    tc.anomaly_guard the step is the guarded one (_make_guarded_train_step),
    with tc.galore_dp_compress the GaLore-DP one."""
    axes = M.param_axes(cfg)
    opt = build_optimizer(tc, param_axes=axes)

    def loss_of(params, batch):
        return M.loss_fn(cfg, params, batch, z_loss=tc.z_loss)

    if tc.anomaly_guard:
        if tc.galore_dp_compress or tc.galore_fused_apply:
            raise ValueError("anomaly_guard wraps the default/chain train step; the "
                             "galore_dp_compress and galore_fused_apply fast paths have "
                             "no guarded variant yet")
        return _make_guarded_train_step(tc, opt, loss_of), opt

    if tc.galore_dp_compress:
        return _make_compressed_train_step(tc, opt, loss_of, axes), opt

    if tc.galore_fused_apply:
        if tc.microbatch and tc.microbatch > 1:
            raise ValueError("galore_fused_apply does not compose with gradient accumulation "
                             "yet (microbatch > 1)")
        return _make_fused_apply_train_step(tc, opt, loss_of, axes), opt

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


def _make_fused_apply_train_step(tc, opt, loss_of, axes):
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
                                external_refresh=external_refresh(tc), param_axes=axes)

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
    """(loss, metrics, grads) of the global batch: this rank's rows, then the
    world's mean of the gradients (f32, cast back), the loss and the other
    tensor metrics. With tc.microbatch > 1 the rows are split and the f32
    gradients averaged, as the reference's scan does."""
    loss, metrics, grads = _local_grads_and_loss(tc, loss_of, params, world.shard_batch(batch))
    if not world.in_world():
        return loss, metrics, grads
    grads = tree_unflatten_like(grads, world.all_reduce_mean_many(tree_leaves(grads)))
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    reduced = world.all_reduce_mean_many([loss] + [metrics[k] for k in keys])
    return reduced[0], dict(metrics, **dict(zip(keys, reduced[1:]))), grads


def _local_grads_and_loss(tc, loss_of, params, batch):
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


def _make_compressed_train_step(tc, opt, loss_of, axes):
    """GaLore-DP (tc.galore_dp_compress): each shard's gradient is projected
    first, R = PᵀG (or GP) in f32 on the GaLore leaves and the f32 gradient
    on the others, and the mean of the compact trees is what crosses between
    ranks, r×n a GaLore leaf in place of m×n. The chain (its clip first) then
    runs on the compact tree, as the reference's step does, and GaLore takes
    it pre-projected. With no world the batch is split into the reference's
    two virtual shards; in a world each rank's rows are its one shard and
    the mean is an all-reduce, under ZeRO-2 a reduce-scatter onto the
    owners' rank blocks (ZeRO-1 all-reduces and GaLore keeps its block)."""
    gcfg = effective_galore_config(tc)
    idx = galore_state_index(tc)
    mgr = SubspaceManager(gcfg, param_axes=axes)

    def train_step(params, opt_state, batch):
        plans = tree_leaves(mgr.plans(params))
        layout = ZeroLayout(params, gcfg, param_axes=axes) if gcfg.zero else None
        proj = opt_state[idx]["proj"]
        if layout is not None:  # every rank projects with the whole P
            proj = layout.gather_proj(proj)
        leaves = tree_leaves(params)
        Ps = [read_projector(P, proj_shape(p, pl)) if pl.galore else None
              for p, P, pl in zip(leaves, flatten_up_to(params, proj), plans)]
        shards = ([world.shard_batch(batch)] if world.in_world()
                  else [world.shard_batch(batch, k=k, n=2) for k in range(2)])
        acc, losses = None, []
        for b in shards:
            loss, _ = loss_of(params, b)
            gs = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                folded = [(ref.galore_project(P, g) if pl.side == "left"
                           else ref.galore_project_right(P, g)) if pl.galore else g.float()
                          for g, P, pl in zip(gs, Ps, plans)]
            acc = folded if acc is None else [a + f for a, f in zip(acc, folded)]
            losses.append(loss.detach())
        with torch.no_grad():
            compact = [x / len(shards) for x in acc]
            dims = layout.dims if layout is not None else [None] * len(acc)
            owned = [gcfg.zero == 2 and pl.galore and d["moment"] is not None
                     for pl, d in zip(plans, dims)]
            rest = [i for i, o in enumerate(owned) if not o]
            reduced = world.all_reduce_mean_many([compact[i] for i in rest]
                                                 + [torch.stack(losses).mean()])
            for i, x in zip(rest, reduced):
                compact[i] = x
            loss = reduced[-1]
            for i in (i for i, o in enumerate(owned) if o):  # ZeRO-2: onto the owners
                compact[i] = world.reduce_scatter_mean(compact[i],
                                                       compact[i].ndim + dims[i]["moment"])
            updates, opt_state = opt.update(tree_unflatten_like(params, compact), opt_state,
                                            params)
            params = apply_updates(params, updates)
        return params, opt_state, {"loss": loss}

    return train_step


def make_refresh_grads(cfg: ModelConfig, tc: TrainConfig):
    """refresh_grads(params, batch) -> grads: the refresh's own gradient, on
    the batch's first microbatch (the whole batch without accumulation), as
    the reference's refresh programs take it; raw, not clipped. In a world
    each rank differentiates its own rows and the gradients are averaged
    (f32, cast back), so every rank refreshes from the same gradient."""

    def refresh_grads(params, batch):
        batch = world.shard_batch(batch)
        if tc.microbatch and tc.microbatch > 1:
            batch = {k: v.chunk(tc.microbatch, dim=0)[0] for k, v in batch.items()}
        loss, _ = M.loss_fn(cfg, params, batch, z_loss=tc.z_loss)
        grads = list(torch.autograd.grad(loss, tree_leaves(params)))
        return tree_unflatten_like(params, world.all_reduce_mean_many(grads))

    return refresh_grads


def shard_units(mgr, grads, sub, step):
    """The sharded refresh's SVD work at `step` (None: every leaf), this
    rank's units computed and not yet summed over the world: (their P list
    for ``sum_units``, the guard's verdict, {"units": this rank's unit
    count, "loads": every rank's load}). `sub` is the galore state's
    {"step", "key", "schedule"} part."""
    plans = mgr.plans(grads)
    sched = sub.get("schedule")
    eff = sub["step"] if step is None else step
    assignment, loads = mgr.partition_refresh(grads, step, world.n_dp(), plans)
    valid = mgr._snapshot_valid(grads, mgr.due_mask(plans, sched, eff, step is None))
    pre = mgr.sharded_projector_tree(grads, plans, sched, sub["key"], step=eff,
                                     assignment=assignment, force_all=step is None,
                                     key_step=sub["step"], valid=valid)
    units = sum(int((a == world.rank()).sum())
                for a, P in zip(flatten_up_to(plans, assignment), pre) if P is not None)
    return pre, valid, {"units": units, "loads": loads.tolist()}


def make_refresh_step(cfg: ModelConfig, tc: TrainConfig):
    """The external refresh: refresh_step(params, opt_state, batch, step=None)
    -> opt_state, the galore state's projectors (and adaptive schedule)
    refreshed from the gradient of `batch`. step None refreshes every
    projector; a step only the leaves due at it (core/galore.py
    ``refresh_projectors``). With tc.galore_refresh_shard in a world of
    more than one rank each rank computes its share of the SVD units
    (``shard_units``); ``refresh_step.last`` then holds this rank's unit
    count and every rank's load."""
    if tc.galore is None:
        raise ValueError("the refresh step needs a GaLore config")
    gcfg = effective_galore_config(tc)
    idx = galore_state_index(tc)
    axes = M.param_axes(cfg)
    mgr = SubspaceManager(gcfg, param_axes=axes)
    refresh_grads = make_refresh_grads(cfg, tc)

    def refresh_step(params, opt_state, batch, step=None):
        grads = refresh_grads(params, batch)
        kw = {}
        with torch.no_grad():
            if tc.galore_refresh_shard and world.n_dp() > 1:
                pre, valid, refresh_step.last = shard_units(mgr, grads, opt_state[idx], step)
                kw = dict(precomputed=sum_units(pre), valid=valid)
            g = refresh_projectors(grads, opt_state[idx], gcfg, step=step, param_axes=axes, **kw)
        return opt_state[:idx] + (g,) + opt_state[idx + 1:]

    refresh_step.last = None
    return refresh_step


def make_async_refresh_step(cfg: ModelConfig, tc: TrainConfig):
    """refresh_pending(params, galore_sub, batch, step=None) -> pending: the
    refresh written into a pending buffer, never the state. `galore_sub` is
    the {"step", "key", "proj"[, "schedule"]} slice of the galore state: the
    moments never enter it. Dueness as make_refresh_step's, and the sharded
    refresh's units as its. The async driver (launch/train.py) runs its
    parts apart: the gradient on a CUDA stream of its own, the SVDs on a host
    thread, the sum of the owners' units at the swap."""
    if tc.galore is None:
        raise ValueError("the async refresh needs a GaLore config")
    gcfg = effective_galore_config(tc)
    axes = M.param_axes(cfg)
    mgr = SubspaceManager(gcfg, param_axes=axes)
    refresh_grads = make_refresh_grads(cfg, tc)

    def refresh_pending(params, sub, batch, step=None):
        grads = refresh_grads(params, batch)
        kw = {}
        with torch.no_grad():
            if gcfg.zero:  # the buffer is the full layout
                sub = dict(sub, proj=ZeroLayout(params, gcfg, param_axes=axes).gather_proj(
                    sub["proj"]))
            if tc.galore_refresh_shard and world.n_dp() > 1:
                pre, valid, _ = shard_units(mgr, grads, sub, step)
                kw = dict(precomputed=sum_units(pre), valid=valid)
            return refresh_projectors_pending(grads, sub, gcfg, step=step, param_axes=axes,
                                              **kw)

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

    axes = M.param_axes(cfg)

    def swap_step(opt_state, pending, params):
        with torch.no_grad():
            g = swap_pending_state(params, opt_state[idx], pending, gcfg, param_axes=axes)
        return opt_state[:idx] + (g,) + opt_state[idx + 1:]

    return swap_step


def make_prefill_step(cfg: ModelConfig):
    """prefill(params, cache, batch) -> (last_logits (B, V), cache): the
    prompt's K/V written at 0 of a contiguous cache (in place); the SSD
    layers' final state and conv histories written into theirs (ssm, and
    Jamba's tuple of caches)."""

    def prefill_step(params, cache, batch):
        with torch.inference_mode():
            logits, cache = M.forward_cached(cfg, params, batch, cache=cache, cache_pos=0)
        return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, with_logits: bool = False):
    """decode(params, cache, tokens (B, 1), pos) -> (next_tokens (B,), cache):
    one token a row written at `pos` of a contiguous cache (the SSD layers'
    state and conv histories advanced by one token), greedy. With
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
