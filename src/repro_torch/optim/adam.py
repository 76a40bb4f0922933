"""Adam / AdamW (Kingma & Ba 2015; Loshchilov & Hutter 2019), fp32 state
(port of repro/optim/adam.py)."""
from __future__ import annotations

import torch

from repro_torch.optim.transform import GradientTransformation, _device_of
from repro_torch.utils import tree_map


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> GradientTransformation:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=_device_of(params))}

    def update(grads, state, params=None):
        count = state["count"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(), state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g.float().square(), state["v"], grads)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()
        out = tree_map(lambda m_, v_, g: ((m_ / c1) / (torch.sqrt(v_ / c2) + eps)).to(g.dtype),
                       m, v, grads)
        return out, {"m": m, "v": v, "count": count}

    return GradientTransformation(init, update)
