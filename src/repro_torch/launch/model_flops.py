"""Analytic MODEL_FLOPS = 6·N·D (train) / 2·N·D (inference), N active for MoE
(port of repro/launch/model_flops.py).

N is counted from the port's own parameter shapes, ``init_params`` on the
meta device (nothing is allocated), and "active" scales the expert leaves —
those whose logical axes (``models/model.py::param_axes``) carry "experts" —
by K/E. The ratio MODEL_FLOPS / counted FLOPs (launch/dryrun.py's
``useful_flops_ratio``) shows what the 6ND convention leaves out: attention,
the router, remat recompute and the GaLore projections.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.models import model as M
from repro_torch.utils import is_axes, tree_leaves_with_path


def _axes_by_path(tree, prefix: tuple = ()) -> dict:
    """{dotted path: logical axes} of a param_axes tree (tuples of labels are
    leaves; a tuple of dicts, Jamba's blocks, is structure)."""
    if is_axes(tree):
        return {".".join(map(str, prefix)): tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {k: v for key, sub in items for k, v in _axes_by_path(sub, prefix + (key,)).items()}


def param_counts(cfg: ModelConfig) -> dict:
    """{"total", "active"} parameter counts; active scales expert weights by K/E."""
    params = M.init_params(cfg, device="meta")
    axes = _axes_by_path(M.param_axes(cfg))
    total, active = 0, 0.0
    for path, leaf in tree_leaves_with_path(params):
        n = math.prod(leaf.shape)
        total += n
        ax = axes.get(path)
        if ax is not None and "experts" in ax and cfg.n_experts > 0:
            active += n * (cfg.experts_per_token / cfg.n_experts)
        else:
            active += n
    return {"total": total, "active": active}


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """Global analytic FLOPs for one step of the cell."""
    cell = SHAPES[shape_name]
    n_active = param_counts(cfg)["active"]
    if cell.kind == "train":
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    # decode: one token per sequence per step
    return 2.0 * n_active * cell.global_batch
