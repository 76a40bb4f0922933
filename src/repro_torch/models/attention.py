"""Grouped-query attention, training path (port of repro/models/attention.py::attend).

Plain tensor ops as the reference is plain jnp — no fused attention operator,
which would change the numerics: scores are computed and masked in f32
(``NEG_INF`` applied in f32), the softmax subtracts a detached row max, and
the probabilities are cast back to V's dtype for the value product.
"""
from __future__ import annotations

import torch

from repro_torch.models import rope as rope_lib
from repro_torch.models.layers import _init_normal

NEG_INF = -2.3819763e38  # large negative for bf16-safe masking (applied in f32)


def init_attention(gen, cfg, dtype, lead=()):
    lead = tuple(lead)
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    return {
        "wq": _init_normal(gen, lead + (d, cfg.n_heads * hd), dtype, fan_in=d),
        "wk": _init_normal(gen, lead + (d, cfg.n_kv_heads * hd), dtype, fan_in=d),
        "wv": _init_normal(gen, lead + (d, cfg.n_kv_heads * hd), dtype, fan_in=d),
        "wo": _init_normal(gen, lead + (cfg.n_heads * hd, d), dtype, fan_in=cfg.n_heads * hd),
    }


def _proj(x, w, n_heads, hd):
    return (x @ w).reshape(x.shape[0], x.shape[1], n_heads, hd)


def _gqa_scores(q, k):
    """q (B,S,K,G,hd), k (B,T,K,hd) -> (B,K,G,S,T) f32 (f32 accumulation and
    output, as ``preferred_element_type=f32`` in the reference)."""
    return torch.einsum("bskgh,btkh->bkgst", q.float(), k.float())


def _gqa_out(probs, v):
    """probs (B,K,G,S,T), v (B,T,K,hd) -> (B,S,K,G,hd)."""
    return torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)


def _masked_softmax(scores, mask):
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True).detach()
    unnorm = torch.exp(scores - m)
    return unnorm / unnorm.sum(dim=-1, keepdim=True)


def attend(cfg, p, x, *, angles):
    """Causal self-attention over x (B, S, D) without a KV cache; returns (B, S, D)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    q = _proj(x, p["wq"], H, hd)
    k = _proj(x, p["wk"], KV, hd)
    v = _proj(x, p["wv"], KV, hd)
    q = rope_lib.apply_rotary(q, angles)
    k = rope_lib.apply_rotary(k, angles)
    q = q.reshape(B, S, KV, G, hd) * (hd ** -0.5)
    pos = torch.arange(S, device=x.device)
    mask = pos[None, :] <= pos[:, None]  # (S, T): key j visible from query i iff j <= i
    probs = _masked_softmax(_gqa_scores(q, k), mask[None, None, None])
    out = _gqa_out(probs, v).reshape(B, S, H * hd)
    return out @ p["wo"]
