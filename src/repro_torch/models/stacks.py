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

Jamba: ``blocks`` is a tuple of ``attn_every`` sub-layer dicts (attention at
``attn_offset``, the SSD layer elsewhere; the MoE FFN where ``layer %
moe_every == moe_offset``, the SwiGLU MLP elsewhere), each leaf stacked over
the n_layers / attn_every blocks, so the leaves are named ``blocks.0.ffn.down``,
``blocks.4.mix.wq``, … as in the reference. The reference builds n_layers //
attn_every blocks and silently drops the remaining layers; here a depth that
is not whole blocks raises. Its cache is the matching tuple of per-kind
caches, each stacked over blocks. ``remat="full"`` recomputes each block.

Whisper: the encoder stack (pre-norm ln1 → bidirectional attention → ln2 →
MLP) and the cross-decoder stack (ln1 → causal self-attention with the
cache → ln2 → cross-attention over the encoder's K/V → ln3 → MLP), one layer
a unit; ``compute_enc_kv`` projects the encoder output through every
layer's cross wk / wv.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    init_mlp,
    init_norm,
    mlp_axes,
    norm_axes,
)
from repro_torch.utils import is_axes, unstack

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


def stack_axes(ax_tree):
    """Every axes tuple of `ax_tree` behind the stacked "layers" dim."""
    if is_axes(ax_tree):
        return ("layers",) + ax_tree
    if isinstance(ax_tree, dict):
        return {k: stack_axes(v) for k, v in ax_tree.items()}
    return tuple(stack_axes(v) for v in ax_tree)


def decoder_stack_axes(cfg):
    ffn = moe_lib.moe_axes(cfg) if cfg.n_experts > 0 else mlp_axes(cfg)
    return stack_axes({"attn": attn_lib.attention_axes(cfg), "ln1": norm_axes(cfg),
                       "ln2": norm_axes(cfg), "ffn": ffn})


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

    return run_units(cfg, run_group, x, cfg.n_layers // unit, cache)


# ---------------------------------------------------------------------------
# Jamba hybrid blocks
# ---------------------------------------------------------------------------


def _jamba_block_structure(cfg):
    """Sub-layer kinds within one period: [("attn" | "ssm", is_moe), …]."""
    period = cfg.attn_every
    return [("attn" if i % period == cfg.attn_offset else "ssm",
             cfg.n_experts > 0 and i % cfg.moe_every == cfg.moe_offset) for i in range(period)]


def jamba_blocks(cfg) -> int:
    """The number of period blocks; raises unless n_layers is whole blocks."""
    if cfg.attn_every <= 0 or cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole blocks of "
                         f"attn_every = {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def init_jamba_stack(gen, cfg, dtype):
    nb = jamba_blocks(cfg)
    lead = (nb,)
    block = []
    for kind, is_moe in _jamba_block_structure(cfg):
        sub = {"ln1": init_norm(cfg, dtype, gen.device, lead=lead),
               "ln2": init_norm(cfg, dtype, gen.device, lead=lead)}
        sub["mix"] = (attn_lib.init_attention(gen, cfg, dtype, lead=lead) if kind == "attn"
                      else ssm_lib.init_ssm(gen, cfg, dtype, lead=lead))
        sub["ffn"] = (moe_lib.init_moe(gen, cfg, dtype, lead=lead) if is_moe
                      else init_mlp(gen, cfg, dtype, lead=lead))
        block.append(sub)
    return tuple(block)


def jamba_stack_axes(cfg):
    block = []
    for kind, is_moe in _jamba_block_structure(cfg):
        block.append({"ln1": norm_axes(cfg), "ln2": norm_axes(cfg),
                      "mix": (attn_lib.attention_axes(cfg) if kind == "attn"
                              else ssm_lib.ssm_axes(cfg)),
                      "ffn": moe_lib.moe_axes(cfg) if is_moe else mlp_axes(cfg)})
    return stack_axes(tuple(block))


def init_jamba_cache(cfg, batch: int, max_len: int, dtype, device):
    """A tuple of per-sub-layer caches stacked over blocks: attention's {"k",
    "v": (nb, batch, max_len, KV, hd)}, the SSD layer's {"state", "conv_x",
    "conv_B", "conv_C"} with a leading nb."""
    lead = (jamba_blocks(cfg),)
    return tuple(
        attn_lib.init_cache(cfg, batch, max_len, dtype, device, lead=lead) if kind == "attn"
        else ssm_lib.init_ssm_cache(cfg, batch, dtype, device, lead=lead)
        for kind, _ in _jamba_block_structure(cfg))


def jamba_sublayer(cfg, kind: str, is_moe: bool, p, x, *, angles, cache=None, cache_pos=None):
    """One sub-layer of a Jamba block: the mixer (attention or the SSD
    layer) and the FFN (MoE or MLP), each pre-norm and residual. Returns (x,
    the MoE loss or None)."""
    h = apply_norm(cfg, p["ln1"], x)
    if kind == "attn":
        x = x + attn_lib.attend(cfg, p["mix"], h, angles=angles, cache=cache, cache_pos=cache_pos)
    else:
        x = x + ssm_lib.apply_ssm(cfg, p["mix"], h, cache)
    h = apply_norm(cfg, p["ln2"], x)
    if is_moe:
        out, aux = moe_lib.apply_moe(cfg, p["ffn"], h)
        return x + out, aux
    return x + apply_mlp(cfg, p["ffn"], h), None


def apply_jamba_stack(cfg, p, x, *, angles, cache=None, cache_pos=None):
    """x (B, S, D) through every block; returns (x, aux_loss 0-d f32: the MoE
    sub-layers' losses summed). A `cache` (init_jamba_cache's tuple) is
    written in place, each block through its own ``select(0, b)`` views."""
    structure = _jamba_block_structure(cfg)
    nb = jamba_blocks(cfg)
    subs = [unstack(sub, nb) for sub in p]  # subs[i][b]: sub-layer i of block b

    def run_block(x, b):
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (kind, is_moe) in enumerate(structure):
            sc = None if cache is None else {k: v.select(0, b) for k, v in cache[i].items()}
            x, a = jamba_sublayer(cfg, kind, is_moe, subs[i][b], x, angles=angles, cache=sc,
                                  cache_pos=cache_pos)
            if a is not None:
                total = total + a
        return x, total

    return run_units(cfg, run_block, x, nb, cache)


def run_units(cfg, run_unit, x, n_units, cache):
    """x through run_unit(x, u) for u in 0 … n_units − 1, summing the aux
    losses; under remat "full" (no cache, autograd on) each unit is
    recomputed in the backward."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat == "full" and cache is None and torch.is_grad_enabled()
    for u in range(n_units):
        x, a = (checkpoint(run_unit, x, u, use_reentrant=False) if remat else run_unit(x, u))
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Whisper-style encoder / decoder stacks
# ---------------------------------------------------------------------------


def init_encoder_stack(gen, cfg, dtype):
    L = cfg.n_enc_layers
    return {
        "attn": attn_lib.init_attention(gen, cfg, dtype, lead=(L,)),
        "ln1": init_norm(cfg, dtype, gen.device, lead=(L,)),
        "ln2": init_norm(cfg, dtype, gen.device, lead=(L,)),
        "ffn": init_mlp(gen, cfg, dtype, lead=(L,)),
    }


def encoder_stack_axes(cfg):
    return stack_axes({"attn": attn_lib.attention_axes(cfg), "ln1": norm_axes(cfg),
                       "ln2": norm_axes(cfg), "ffn": mlp_axes(cfg)})


def apply_encoder_stack(cfg, p, x):
    """Frames x (B, T, D) through the n_enc_layers encoder layers; returns
    (B, T, D)."""
    layers = unstack(p, cfg.n_enc_layers)
    no_aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_layer(x, layer):
        lp = layers[layer]
        h = apply_norm(cfg, lp["ln1"], x)
        x = x + attn_lib.attend(cfg, lp["attn"], h, angles=None, causal=False)
        return x + apply_mlp(cfg, lp["ffn"], apply_norm(cfg, lp["ln2"], x)), no_aux

    return run_units(cfg, run_layer, x, cfg.n_enc_layers, None)[0]


def init_crossdecoder_stack(gen, cfg, dtype):
    L = cfg.n_layers
    return {
        "self_attn": attn_lib.init_attention(gen, cfg, dtype, lead=(L,)),
        "cross_attn": attn_lib.init_attention(gen, cfg, dtype, lead=(L,), cross=True),
        "ln1": init_norm(cfg, dtype, gen.device, lead=(L,)),
        "ln2": init_norm(cfg, dtype, gen.device, lead=(L,)),
        "ln3": init_norm(cfg, dtype, gen.device, lead=(L,)),
        "ffn": init_mlp(gen, cfg, dtype, lead=(L,)),
    }


def crossdecoder_stack_axes(cfg):
    return stack_axes({"self_attn": attn_lib.attention_axes(cfg),
                       "cross_attn": attn_lib.attention_axes(cfg, cross=True),
                       "ln1": norm_axes(cfg), "ln2": norm_axes(cfg), "ln3": norm_axes(cfg),
                       "ffn": mlp_axes(cfg)})


def apply_crossdecoder_stack(cfg, p, x, enc_kv, *, cache=None, cache_pos=None):
    """x (B, S, D) through the decoder layers; returns (B, S, D). `enc_kv` =
    (k, v), each stacked (L, B, T, KV, hd) (``compute_enc_kv``, or the
    cache's cross K/V); a self-attention `cache` {"k", "v": (L, B, max_len,
    KV, hd)} is written in place through each layer's ``select(0, l)``."""
    L = cfg.n_layers
    layers = unstack(p, L)
    ks, vs = enc_kv[0].unbind(0), enc_kv[1].unbind(0)
    no_aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run_layer(x, layer):
        lp = layers[layer]
        c = None if cache is None else {k: v.select(0, layer) for k, v in cache.items()}
        h = apply_norm(cfg, lp["ln1"], x)
        x = x + attn_lib.attend(cfg, lp["self_attn"], h, angles=None, cache=c,
                                cache_pos=cache_pos)
        h = apply_norm(cfg, lp["ln2"], x)
        x = x + attn_lib.attend(cfg, lp["cross_attn"], h, angles=None,
                                kv_override=(ks[layer], vs[layer]))
        return x + apply_mlp(cfg, lp["ffn"], apply_norm(cfg, lp["ln3"], x)), no_aux

    return run_units(cfg, run_layer, x, L, cache)[0]


def compute_enc_kv(cfg, p, enc_out):
    """The cross-attention K/V of every decoder layer from the encoder output
    (B, T, D): (k, v), each (L, B, T, KV, hd) in the model's dtype."""
    hd = cfg.resolved_head_dim
    cross = unstack(p["cross_attn"], cfg.n_layers)
    ks = [attn_lib._proj(enc_out, lp["wk"], lp.get("bk"), cfg.n_kv_heads, hd) for lp in cross]
    vs = [attn_lib._proj(enc_out, lp["wv"], lp.get("bv"), cfg.n_kv_heads, hd) for lp in cross]
    return torch.stack(ks), torch.stack(vs)
