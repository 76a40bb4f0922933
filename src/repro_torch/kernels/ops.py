"""Public kernel API of the port (counterpart of repro/kernels/ops.py).

The JAX dispatch picks Pallas on a TPU and the jnp reference elsewhere, and
falls back to tiled kernels when a leaf's projector does not fit VMEM. Here
each wrapper dispatches on the device of its tensors — the plain version for
CPU tensors, the Hopper kernel for CUDA tensors — and the kernels stream P,
so no shape needs a fallback. Every GaLore step takes P either as f32 or as
the packed int4 qstate, which the kernel dequantizes itself. The
``*_apply_step*`` forms update the weight in place instead of returning G̃.
``adam8bit_step`` is the flat 8-bit Adam update of a whole leaf.
"""
from repro_torch.kernels import galore_fused
from repro_torch.kernels.adam8bit_update import adam8bit_update
from repro_torch.kernels.galore_fused import (
    galore_fused_adam8_apply_step,
    galore_fused_adam8_apply_step_right,
    galore_fused_adam8_step,
    galore_fused_adam8_step_right,
    galore_fused_adam_apply_step,
    galore_fused_adam_apply_step_right,
    galore_fused_adam_step,
    galore_fused_adam_step_right,
)
from repro_torch.kernels.ref import lowrank_adam_update

__all__ = ["adam8bit_step", "galore_fused_adam8_apply_step",
           "galore_fused_adam8_apply_step_right", "galore_fused_adam8_step",
           "galore_fused_adam8_step_right", "galore_fused_adam_apply_step",
           "galore_fused_adam_apply_step_right", "galore_fused_adam_step",
           "galore_fused_adam_step_right", "lowrank_adam_update", "reset_launch_counts"]


# fused dequant → Adam → requant of one leaf on the flat (nb, 256) blocks of
# its moments (the leaf in any shape, or its (nb, 256) block view)
adam8bit_step = adam8bit_update


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch counts."""
    galore_fused.reset_launch_counts()
    adam8bit_update.launches = 0
