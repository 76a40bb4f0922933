"""Homogeneous decoder stack over stacked (L, …) parameters (port of the
decoder path of repro/models/stacks.py: ``init_decoder_stack``,
``apply_decoder_stack`` and the ``"full"`` policy of ``_remat_wrap``).

The reference scans over groups of layers; here a Python loop walks the
per-layer views that ``utils.unstack`` takes once per forward. A group is
``full_attn_every`` layers when attention is chunked (the iRoPE pattern:
chunked layers with rope, and the group's last layer global and rope-free),
else one layer. The FFN is the SwiGLU MLP or, with experts, the MoE layer,
whose load-balancing losses are summed over the layers.

A KV cache is threaded through as the stacked tensors themselves —
contiguous (L, B, T, KV, hd) or a paged pool (L, NB, bs, KV, hd) with its
block tables and positions, passed once for every layer — and each layer
writes in place into its own ``select(0, l)`` view.

``remat="full"`` recomputes each group in the backward
(``torch.utils.checkpoint``), only when there is no cache, so a recompute
never writes a cache twice; the reference's ``"scores"`` and ``"names"``
policies are not ported (``model.check_ported``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.utils import unstack

_STACKED = ("k", "v", "kp", "vp")  # cache leaves with a leading L axis


def init_decoder_stack(gen, cfg, dtype):
    L = cfg.n_layers
    ffn = (moe_lib.init_moe(gen, cfg, dtype, lead=(L,)) if cfg.n_experts > 0
           else init_mlp(gen, cfg, dtype, lead=(L,)))
    return {
        "attn": attn_lib.init_attention(gen, cfg, dtype, lead=(L,)),
        "ln1": init_norm(cfg, dtype, gen.device, lead=(L,)),
        "ln2": init_norm(cfg, dtype, gen.device, lead=(L,)),
        "ffn": ffn,
    }


def _decoder_layer(cfg, p, x, *, angles, is_full: bool, cache=None, cache_pos=None):
    """One layer; returns (x, aux). `is_full` makes a chunked model's layer
    global and rope-free (iRoPE)."""
    h = apply_norm(cfg, p["ln1"], x)
    chunk = cfg.attention_chunk
    if chunk > 0 and is_full:
        angles, chunk = None, 0
    x = x + attn_lib.attend(cfg, p["attn"], h, angles=angles, chunk=chunk, cache=cache,
                            cache_pos=cache_pos)
    h = apply_norm(cfg, p["ln2"], x)
    if cfg.n_experts > 0:
        out, aux = moe_lib.apply_moe(cfg, p["ffn"], h)
    else:
        out, aux = apply_mlp(cfg, p["ffn"], h), None
    return x + out, aux


def apply_decoder_stack(cfg, p, x, *, angles, cache=None, cache_pos=None):
    """x (B, S, D) through every layer of the stack; returns (x (B, S, D),
    aux_loss 0-d f32: the sum of the MoE layers' losses, 0 without
    experts). A `cache` (stacked per-layer KV tensors, written in place)
    makes each layer attend through its own slice."""
    # a group: full_attn_every layers under chunked attention, else one
    unit = cfg.full_attn_every if (cfg.full_attn_every > 0 and cfg.attention_chunk > 0) else 1
    if cfg.n_layers % unit:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole groups of {unit}")
    layers = unstack(p, cfg.n_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_group(x, g):
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(unit):
            layer = g * unit + i
            layer_cache = None if cache is None else {
                k: v.select(0, layer) if k in _STACKED else v for k, v in cache.items()}
            x, a = _decoder_layer(cfg, layers[layer], x, angles=angles,
                                  is_full=cfg.uses_full_attn(i), cache=layer_cache,
                                  cache_pos=cache_pos)
            if a is not None:
                total = total + a
        return x, total

    remat = cfg.remat == "full" and cache is None and torch.is_grad_enabled()
    for g in range(cfg.n_layers // unit):
        if remat:
            x, a = checkpoint(run_group, x, g, use_reentrant=False)
        else:
            x, a = run_group(x, g)
        aux = aux + a
    return x, aux
