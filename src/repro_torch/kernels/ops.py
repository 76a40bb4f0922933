"""Public kernel API of the port (counterpart of repro/kernels/ops.py).

The JAX dispatch picks Pallas on a TPU and the jnp reference elsewhere, and
falls back to tiled kernels when a leaf's projector does not fit VMEM. Here
each wrapper dispatches on the device of its tensors — the plain version for
CPU tensors, the Hopper kernel for CUDA tensors — and the kernels stream P,
so no shape needs a fallback. The int8-moment steps take P either as f32 or
as the packed int4 qstate, which the kernel dequantizes itself. The
``*_apply_step*`` forms update the weight in place instead of returning G̃.
"""
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

__all__ = ["galore_fused_adam8_apply_step", "galore_fused_adam8_apply_step_right",
           "galore_fused_adam8_step", "galore_fused_adam8_step_right",
           "galore_fused_adam_apply_step", "galore_fused_adam_apply_step_right",
           "galore_fused_adam_step", "galore_fused_adam_step_right", "lowrank_adam_update"]
