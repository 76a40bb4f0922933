"""Per-step anomaly guard: finiteness and a loss-spike z-score (port of
repro/robust/guard.py).

The same f32 arithmetic as the reference, on 0-d tensors on the run's
device. The reference feeds the verdict to a ``lax.cond`` around the
optimizer update; the port's guarded step (distributed/step.py) reads it on
the host before any optimizer call instead, because the GaLore kernels
update moments (and W) in place — one device→host read a guarded step.

Guard state (a tiny scalar dict, checkpointed as its own group ``guard``):
    mean, var — EMA estimates of the recent loss level and spread (f32)
    count     — accepted steps so far (arms the z-score after `warmup`; int32)
    skips     — total rejected steps (int32)

The EMAs absorb only ACCEPTED losses, so a rejected spike never drags the
baseline toward itself.
"""
from __future__ import annotations

import torch

from repro_torch.utils import tree_leaves


def init_guard_state(device=None) -> dict:
    z = lambda dt: torch.zeros((), dtype=dt, device=device)  # noqa: E731
    return {"mean": z(torch.float32), "var": z(torch.float32),
            "count": z(torch.int32), "skips": z(torch.int32)}


def guard_verdict(guard: dict, loss, gnorm, *, zmax: float, warmup: int) -> torch.Tensor:
    """0-d bool: finite loss AND finite grad norm AND, once `warmup` steps
    were accepted, a loss z-score within `zmax` (a NaN comparison is False,
    so a NaN loss fails the finiteness test, not the spike test)."""
    loss = torch.as_tensor(loss, dtype=torch.float32)
    finite = torch.isfinite(loss) & torch.isfinite(torch.as_tensor(gnorm, dtype=torch.float32))
    armed = guard["count"] >= warmup
    std = torch.sqrt(torch.clamp(guard["var"], min=0.0))
    z = (loss - guard["mean"]) / (std + 1e-8)
    return finite & ~(armed & (z > zmax))


def guard_update(guard: dict, loss, ok, *, ema: float) -> dict:
    """Advance the monitor: the EMA mean and variance absorb the loss only on
    an accepted step (``torch.where`` selects, so a rejected NaN never enters
    the state)."""
    loss = torch.as_tensor(loss, dtype=torch.float32)
    first = guard["count"] == 0
    delta = loss - guard["mean"]
    mean2 = torch.where(first, loss, guard["mean"] + (1.0 - ema) * delta)
    var2 = torch.where(first, torch.zeros_like(loss),
                       ema * (guard["var"] + (1.0 - ema) * delta * delta))
    ok_i = ok.to(torch.int32)
    return {"mean": torch.where(ok, mean2, guard["mean"]),
            "var": torch.where(ok, var2, guard["var"]),
            "count": guard["count"] + ok_i,
            "skips": guard["skips"] + (1 - ok_i)}


def guard_step(guard: dict, loss, gnorm, *, zmax: float, warmup: int, ema: float):
    """(ok, guard') — the one call the train step makes."""
    ok = guard_verdict(guard, loss, gnorm, zmax=zmax, warmup=warmup)
    return ok, guard_update(guard, loss, ok, ema=ema)


def global_grad_norm(grads) -> torch.Tensor:
    """Global L2 norm over every leaf, in f32 (clip_by_global_norm's
    reduction)."""
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(grads)))
