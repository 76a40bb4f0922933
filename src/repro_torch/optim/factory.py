"""Build the optimizer pipeline from a TrainConfig (port of repro/optim/factory.py).

Pipeline (the reference's ordering):
    clip_by_global_norm -> [galore(Adam)] or Adam -> add_decayed_weights -> -lr schedule
"""
from __future__ import annotations

from repro_torch.configs.base import TrainConfig
from repro_torch.core.galore import galore
from repro_torch.optim import schedules
from repro_torch.optim.adam import scale_by_adam
from repro_torch.optim.transform import (
    GradientTransformation,
    add_decayed_weights,
    chain,
    clip_by_global_norm,
    scale_by_schedule,
)


def build_optimizer(tc: TrainConfig) -> GradientTransformation:
    if tc.optimizer not in ("adam", "adamw"):
        raise NotImplementedError(f"optimizer {tc.optimizer!r} is not ported yet (adam, adamw)")
    if tc.galore is not None:
        stats = galore(tc.galore, b1=tc.b1, b2=tc.b2, eps=tc.eps, fused=tc.galore_fused_adam)
    elif tc.galore_fused_adam:
        raise ValueError("galore_fused_adam requires a GaLore config")
    else:
        stats = scale_by_adam(tc.b1, tc.b2, tc.eps)
    parts = []
    if tc.grad_clip > 0:
        parts.append(clip_by_global_norm(tc.grad_clip))
    parts.append(stats)
    if tc.weight_decay > 0 and tc.optimizer == "adamw":
        parts.append(add_decayed_weights(tc.weight_decay))
    sched = schedules.warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps)
    parts.append(scale_by_schedule(lambda c: -sched(c)))
    return chain(*parts)
