"""8-bit Adam (Dettmers et al., 2022): blockwise-quantized moment states
(port of repro/optim/adam8bit.py, the paper's 8-bit Adam baseline).

Moments are stored in the flat INT8 codec (uint8 codes + one absmax per
256-element block, ≈ 1 byte + 1/64 float a moment element against 4 bytes for
fp32 Adam). The update of a quantized leaf is one launch of the flat 8-bit
Adam kernel (``ops.adam8bit_step``: dequant → fp32 Adam → requant, codes and
scales updated in place); on CPU tensors the same step runs as its plain
version.

Small leaves (< min_quant_size elements) stay fp32 and get the plain Adam
math. The decision is made once, at init, and ``update`` reads it back from
the state structure, so the two can never disagree. (8-bit GaLore does not
compose this transform: ``optim/factory.py`` routes ``optimizer="adam8bit"``
with GaLore through the quantized moments of ``core/galore.py``.)

State layout (the reference's): {"mv": {leaf: {"m", "v"}}, "count"}, each
quantized moment a {"q": codes (nb, 256) u8, "scale": (nb,) f32} dict.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops, ref
from repro_torch.optim import quant8
from repro_torch.optim.transform import GradientTransformation, _device_of
from repro_torch.quant import codec
from repro_torch.quant.policy import MIN_QUANT_SIZE
from repro_torch.utils import flatten_up_to, tree_leaves, tree_map, tree_unflatten_like


def scale_by_adam8bit(b1=0.9, b2=0.999, eps=1e-8,
                      min_quant_size=MIN_QUANT_SIZE) -> GradientTransformation:
    def init(params):
        def per_leaf(p):
            zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            if p.numel() >= min_quant_size:
                return {"m": quant8.quant_state(zeros, signed=True),
                        "v": quant8.quant_state(zeros, signed=False)}
            return {"m": zeros, "v": zeros.clone()}

        return {"mv": tree_map(per_leaf, params),
                "count": torch.zeros((), dtype=torch.int32, device=_device_of(params))}

    def update(grads, state, params=None):
        count = state["count"] + 1

        def per_leaf(g, mv):
            # the state structure IS the quantization decision (made at init)
            if codec.is_qstate(mv["m"]):
                m, v = mv["m"], mv["v"]
                upd = ops.adam8bit_step(g.contiguous(), m["q"], m["scale"], v["q"], v["scale"],
                                        count, b1=b1, b2=b2, eps=eps)[0]
                return upd, mv  # codes and scales updated in place
            upd, m, v = ref.lowrank_adam_update(g, mv["m"], mv["v"], count, b1, b2, eps)
            return upd.to(g.dtype), {"m": m, "v": v}

        pairs = [per_leaf(g, mv)
                 for g, mv in zip(tree_leaves(grads), flatten_up_to(grads, state["mv"]))]
        updates = tree_unflatten_like(grads, [u for u, _ in pairs])
        new_mv = tree_unflatten_like(grads, [mv for _, mv in pairs])
        return updates, {"mv": new_mv, "count": count}

    return GradientTransformation(init, update)


def adam8bit_state_bytes(params, min_quant_size=MIN_QUANT_SIZE) -> int:
    """Analytic bytes of scale_by_adam8bit's moments: per quantized leaf two
    moments of ⌈n/256⌉ blocks, 256 code bytes and one f32 scale each; per
    fp32 leaf 8 bytes an element."""
    total = 0
    for p in tree_leaves(params):
        n = math.prod(p.shape)
        nb = -(-n // codec.BLOCK)
        total += 2 * nb * (codec.BLOCK + 4) if n >= min_quant_size else 8 * n
    return total
