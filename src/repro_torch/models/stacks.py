"""Homogeneous decoder stack over stacked (L, …) parameters (port of the dense
path of repro/models/stacks.py: ``init_decoder_stack`` / ``apply_decoder_stack``).

The reference scans over the leading L axis; here a Python loop walks the
per-layer views that ``utils.unstack`` takes once per forward. A KV cache is
threaded through as the stacked tensors themselves — contiguous (L, B, T, KV,
hd) or a paged pool (L, NB, bs, KV, hd) with its block tables and positions,
passed once for every layer — and each layer writes in place into its own
``select(0, l)`` view.
"""
from __future__ import annotations

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.utils import unstack

_STACKED = ("k", "v", "kp", "vp")  # cache leaves with a leading L axis


def init_decoder_stack(gen, cfg, dtype):
    L = cfg.n_layers
    return {
        "attn": attn_lib.init_attention(gen, cfg, dtype, lead=(L,)),
        "ln1": init_norm(cfg, dtype, gen.device, lead=(L,)),
        "ln2": init_norm(cfg, dtype, gen.device, lead=(L,)),
        "ffn": init_mlp(gen, cfg, dtype, lead=(L,)),
    }


def _decoder_layer(cfg, p, x, *, angles, cache=None, cache_pos=None):
    h = apply_norm(cfg, p["ln1"], x)
    x = x + attn_lib.attend(cfg, p["attn"], h, angles=angles, cache=cache, cache_pos=cache_pos)
    h = apply_norm(cfg, p["ln2"], x)
    return x + apply_mlp(cfg, p["ffn"], h)


def apply_decoder_stack(cfg, p, x, *, angles, cache=None, cache_pos=None):
    """x (B, S, D) through every layer of the stack; returns (B, S, D). A
    `cache` (stacked per-layer KV tensors, written in place) makes each layer
    attend through its own slice."""
    for layer, layer_p in enumerate(unstack(p, cfg.n_layers)):
        layer_cache = None if cache is None else {
            k: v.select(0, layer) if k in _STACKED else v for k, v in cache.items()}
        x = _decoder_layer(cfg, layer_p, x, angles=angles, cache=layer_cache,
                           cache_pos=cache_pos)
    return x
