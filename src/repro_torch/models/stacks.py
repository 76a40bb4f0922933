"""Homogeneous decoder stack over stacked (L, …) parameters (port of the dense
path of repro/models/stacks.py: ``init_decoder_stack`` / ``apply_decoder_stack``).

The reference scans over the leading L axis; here a Python loop walks the
per-layer views that ``utils.unstack`` takes once per forward.
"""
from __future__ import annotations

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.utils import unstack


def init_decoder_stack(gen, cfg, dtype):
    L = cfg.n_layers
    return {
        "attn": attn_lib.init_attention(gen, cfg, dtype, lead=(L,)),
        "ln1": init_norm(cfg, dtype, gen.device, lead=(L,)),
        "ln2": init_norm(cfg, dtype, gen.device, lead=(L,)),
        "ffn": init_mlp(gen, cfg, dtype, lead=(L,)),
    }


def _decoder_layer(cfg, p, x, *, angles):
    h = apply_norm(cfg, p["ln1"], x)
    x = x + attn_lib.attend(cfg, p["attn"], h, angles=angles)
    h = apply_norm(cfg, p["ln2"], x)
    return x + apply_mlp(cfg, p["ffn"], h)


def apply_decoder_stack(cfg, p, x, *, angles):
    """x (B, S, D) through every layer of the stack; returns (B, S, D)."""
    for layer_p in unstack(p, cfg.n_layers):
        x = _decoder_layer(cfg, layer_p, x, angles=angles)
    return x
