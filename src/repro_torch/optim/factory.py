"""Build the optimizer pipeline from a TrainConfig (port of repro/optim/factory.py).

Pipeline (the reference's ordering):
    clip_by_global_norm -> [galore(inner)] -> add_decayed_weights -> -lr schedule
GaLore wraps only the statistics transform (Adam, 8-bit Adam, Adafactor, or
SGD's momentum trace); weight decay (AdamW only) and the lr act on
full-shape updates, as in the reference.

8-bit GaLore: ``optimizer="adam8bit"`` with GaLore routes through the
quantized-moment state of ``core/galore.py`` (``effective_galore_config``
turns the policy's moments to int8), as the reference does; without GaLore
it is the paper's 8-bit Adam baseline, ``optim/adam8bit.py``. With an
Adam-shaped optimizer GaLore owns the Adam math (its managed path, fused or
not); with Adafactor or SGD it runs the reference's composable path around
the inner transform (project → inner → project back). An external or async
refresh (``external_refresh``) takes the refresh out of the GaLore update,
as the reference's does. The low-rank weight baselines (LoRA, ReLoRA,
low-rank) train adaptors, not through this factory: ``optim/lowrank.py``.

The data-parallel modes: ``galore_dp_compress`` hands GaLore pre-projected
gradients (``pre_projected``), and ``galore_zero`` is routed into
``GaLoreConfig.zero``, validated as the reference validates it (0, 1 or 2;
ZeRO-2 needs the compress path and fp32 moments). ZeRO owns Adam-shaped
state; under Adafactor or SGD the state stays whole on every rank. Under
ZeRO-2 the chain's clip sums the squares of the reduce-scattered blocks
over the world.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import GaLoreConfig, TrainConfig
from repro_torch.core.galore import galore
from repro_torch.distributed.state_sharding import ZeroLayout
from repro_torch.optim import schedules
from repro_torch.optim.adafactor import scale_by_adafactor
from repro_torch.optim.adam import scale_by_adam
from repro_torch.optim.adam8bit import scale_by_adam8bit
from repro_torch.optim.transform import (
    GradientTransformation,
    add_decayed_weights,
    chain,
    clip_by_global_norm,
    scale_by_schedule,
    trace,
)

_ADAM_SHAPED = ("adam", "adamw", "adam8bit")


def effective_galore_config(tc: TrainConfig) -> GaLoreConfig | None:
    """tc.galore with the adam8bit composition routed through QuantPolicy
    (moments forced to int8 when the policy left them fp32)."""
    if tc.galore is None:
        return None
    g = tc.galore
    if tc.optimizer == "adam8bit" and g.quant.moments == "fp32":
        g = dataclasses.replace(g, quant=dataclasses.replace(g.quant, moments="int8"))
    if tc.galore_zero and g.zero != tc.galore_zero:
        g = dataclasses.replace(g, zero=tc.galore_zero)
    if g.zero and tc.optimizer not in _ADAM_SHAPED:  # no Adam moments to own
        g = dataclasses.replace(g, zero=0)
    return g


def _stats_transform(tc: TrainConfig) -> GradientTransformation:
    if tc.optimizer in ("adam", "adamw"):
        return scale_by_adam(tc.b1, tc.b2, tc.eps)
    if tc.optimizer == "adam8bit":
        return scale_by_adam8bit(tc.b1, tc.b2, tc.eps)
    if tc.optimizer == "adafactor":
        return scale_by_adafactor(beta1=tc.b1)
    if tc.optimizer == "sgd":
        return trace(momentum=tc.b1)
    raise ValueError(f"unknown optimizer {tc.optimizer!r}")


def external_refresh(tc: TrainConfig) -> bool:
    """Whether the launcher, not the GaLore update, refreshes the projectors
    (``galore_external_refresh``, or ``galore_refresh_shard`` or
    ``galore_refresh_async``, which imply it)."""
    return tc.galore is not None and (tc.galore_external_refresh or tc.galore_refresh_shard
                                      or tc.galore_refresh_async)


def galore_state_index(tc: TrainConfig) -> int:
    """Position of the galore/stats state inside the chain state tuple."""
    return 1 if tc.grad_clip > 0 else 0


def _zero2_blocks(gcfg: GaLoreConfig, param_axes):
    """ZeRO-2's clip marks: the GaLore leaves whose compact gradient arrives
    as this rank's block."""

    def blocks(grads, params):
        layout = ZeroLayout(params, gcfg, param_axes=param_axes)
        return [pl.galore and d["moment"] is not None for pl, d in zip(layout.plans, layout.dims)]

    return blocks


def build_optimizer(tc: TrainConfig, param_axes=None) -> GradientTransformation:
    """The optimizer chain for `tc`; `param_axes` (models/model.py::param_axes)
    labels the leaves for GaLore's tp_aware_side."""
    gcfg = effective_galore_config(tc)
    if gcfg is not None:
        if tc.galore_fused_adam and tc.optimizer not in _ADAM_SHAPED:
            raise ValueError(f"galore_fused_adam requires an Adam-shaped inner optimizer, "
                             f"got {tc.optimizer!r}")
        if gcfg.quant.quantizes_moments and tc.optimizer not in _ADAM_SHAPED:
            raise ValueError(f"quantized moments require an Adam-shaped inner optimizer "
                             f"(galore manages the Adam math itself), got {tc.optimizer!r}")
        if tc.galore_fused_apply and not tc.galore_fused_adam:
            raise ValueError("galore_fused_apply requires galore_fused_adam")
        if gcfg.zero not in (0, 1, 2):
            raise ValueError(f"galore_zero must be 0, 1 or 2, got {gcfg.zero!r}")
        if gcfg.zero == 2:
            if not tc.galore_dp_compress:
                raise ValueError("galore_zero=2 reduce-scatters projected gradients, which "
                                 "requires the galore_dp_compress step path")
            if gcfg.quant.quantizes_moments:
                raise ValueError("galore_zero=2 requires fp32 moments (quantized moments are "
                                 "incompatible with pre_projected gradients)")
        # Adam-shaped: galore owns the Adam math (no inner); otherwise the
        # composable path around the inner statistics transform. The async
        # double buffer runs the refresh in a step of its own too
        inner = None if tc.optimizer in _ADAM_SHAPED else _stats_transform(tc)
        stats = galore(gcfg, inner=inner, b1=tc.b1, b2=tc.b2, eps=tc.eps,
                       fused=tc.galore_fused_adam, seed=tc.seed,
                       external_refresh=external_refresh(tc),
                       pre_projected=tc.galore_dp_compress, param_axes=param_axes)
    elif tc.galore_fused_adam:
        raise ValueError("galore_fused_adam requires a GaLore config")
    else:
        stats = _stats_transform(tc)
    parts = []
    if tc.grad_clip > 0:
        zero2 = gcfg is not None and gcfg.zero == 2
        parts.append(clip_by_global_norm(
            tc.grad_clip, blocks=_zero2_blocks(gcfg, param_axes) if zero2 else None))
    parts.append(stats)
    if tc.weight_decay > 0 and tc.optimizer == "adamw":
        parts.append(add_decayed_weights(tc.weight_decay))
    sched = schedules.warmup_cosine(tc.lr, tc.warmup_steps, tc.total_steps)
    parts.append(scale_by_schedule(lambda c: -sched(c)))
    return chain(*parts)
