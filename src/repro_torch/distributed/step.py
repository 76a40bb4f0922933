"""The train step (port of the default, fused-apply and anomaly-guarded
branches of repro/distributed/step.py::make_train_step and its
``_grads_and_loss``), on a single device."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.galore import make_fused_apply
from repro_torch.models import model as M
from repro_torch.optim import schedules
from repro_torch.optim.factory import build_optimizer, effective_galore_config, galore_state_index
from repro_torch.optim.transform import apply_updates, clip_by_global_norm
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
    """The W-in-place step (tc.galore_fused_apply): clip → one fused kernel per
    GaLore leaf that folds projection, Adam, back-projection and the weight
    update W ← W + η·(G̃ + wd·W) into one launch, so no full-size f32 update
    tree is made. The optimizer state keeps the chain's layout (clip, galore,
    [wd], schedule), so states swap freely with the emit path, which stays
    the numerics oracle."""
    gcfg = effective_galore_config(tc)
    if gcfg is None:
        raise ValueError("galore_fused_apply requires a GaLore config")
    idx = galore_state_index(tc)
    clip = clip_by_global_norm(tc.grad_clip)
    sched = schedules.warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps)
    wd = tc.weight_decay if tc.optimizer == "adamw" else 0.0
    apply_fn = make_fused_apply(gcfg, b1=tc.b1, b2=tc.b2, eps=tc.eps, weight_decay=wd)

    def train_step(params, opt_state, batch):
        _, metrics, grads = _grads_and_loss(tc, loss_of, params, batch)
        with torch.no_grad():
            if tc.grad_clip > 0:  # the chain's own clip, so the two paths clip alike
                grads, _ = clip.update(grads, ())
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
