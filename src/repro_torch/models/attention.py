"""Grouped-query attention with its KV caches (port of the causal, rope paths
of repro/models/attention.py::attend, ``_paged_attend``, ``init_cache`` and
``init_paged_cache``).

Plain tensor ops as the reference is plain jnp — no fused attention operator,
which would change the numerics: scores are computed and masked in f32
(``NEG_INF`` applied in f32), the softmax subtracts a detached row max, and
the probabilities are cast back to V's dtype for the value product.

Caches are written in place (the reference's donated ``.at[].set``): a
contiguous cache {"k", "v": (B, T, KV, hd)} at 0 by a prefill (S > 1) or at
``cache_pos`` by a decode step (S == 1); a paged one {"kp", "vp": (NB, bs, KV,
hd) pooled blocks, "bt": (B, nb) block tables, "pos": (B,) next write index}
through the block table.
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


def _paged_attend(q, k, v, cache):
    """Block-table attention over a pooled paged KV cache (the serving engine).

    Write: this call's S tokens go to flat pool slots through the block table.
    Read: each row gathers its nb blocks back into position order, T = nb·bs
    keys, masked causally against the row's own positions. Masked keys (stale,
    scratch or unused slots) contribute exact zeros after the softmax
    (exp(NEG_INF − m) = 0, and 0·finite = 0 — the pool is zeroed at
    allocation, so no slot ever holds a NaN), so the logits equal the
    contiguous cache's.

    Where the reference differs: it clamps a position's block index to the
    table's last block (``jnp.minimum(tgt // bs, nb - 1)``), so a padded
    prefill position past the table (pos0 + C > nb·bs, when max_len_cap is
    not a multiple of prefill_chunk) lands on a real slot of that block and
    overwrites, in the same scatter, the K/V of one of the chunk's real tokens.
    A block index ≥ nb is never a real token (each is below max_len_cap ≤
    nb·bs), so here it goes to scratch block 0, as inactive lanes and padded
    positions inside the table already do; wherever the reference writes no
    two tokens to one slot the result is the reference's.
    """
    B, S = k.shape[0], k.shape[1]
    NB, bs, KV, hd = cache["kp"].shape
    bt, pos = cache["bt"], cache["pos"]
    nb = bt.shape[1]

    tgt = pos.long()[:, None] + torch.arange(S, device=k.device)  # (B, S) token index
    bi = tgt // bs
    blk = torch.gather(bt.long(), 1, bi.clamp(max=nb - 1))
    blk = torch.where(bi < nb, blk, torch.zeros_like(blk))
    flat = (blk * bs + tgt % bs).reshape(-1)  # (B·S,) into the NB·bs pool
    kp = cache["kp"].view(NB * bs, KV, hd)
    vp = cache["vp"].view(NB * bs, KV, hd)
    kp.index_copy_(0, flat, k.reshape(B * S, KV, hd).to(kp.dtype))
    vp.index_copy_(0, flat, v.reshape(B * S, KV, hd).to(vp.dtype))

    rows = bt.long().reshape(-1)
    k_att = cache["kp"][rows].reshape(B, nb * bs, KV, hd)
    v_att = cache["vp"][rows].reshape(B, nb * bs, KV, hd)
    kj = torch.arange(nb * bs, device=k.device)
    mask = kj[None, None, :] <= tgt[:, :, None]  # (B, S, T)
    probs = _masked_softmax(_gqa_scores(q, k_att), mask[:, None, None])
    return _gqa_out(probs, v_att)


def attend(cfg, p, x, *, angles, cache=None, cache_pos=None):
    """Causal self-attention over x (B, S, D); returns (B, S, D).

    With a contiguous `cache` a prefill (S > 1) writes its K/V at 0 and
    attends within itself, a decode step (S == 1) writes at `cache_pos` (an
    int) and attends over the cache up to it; a paged `cache` (``"kp"`` in
    it) writes and reads through its block tables (``_paged_attend``). The
    cache is written in place."""
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
    if cache is not None and "kp" in cache:
        out = _paged_attend(q, k, v, cache)
    elif cache is not None and S == 1:
        cache["k"][:, cache_pos] = k[:, 0]
        cache["v"][:, cache_pos] = v[:, 0]
        valid = torch.arange(cache["k"].shape[1], device=x.device) <= cache_pos
        probs = _masked_softmax(_gqa_scores(q, cache["k"]), valid[None, None, None, None, :])
        out = _gqa_out(probs, cache["v"])
    else:
        if cache is not None:  # prefill: the whole prefix at 0
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
        pos = torch.arange(S, device=x.device)
        mask = pos[None, :] <= pos[:, None]  # (S, T): key j visible from query i iff j <= i
        out = _gqa_out(_masked_softmax(_gqa_scores(q, k), mask[None, None, None]), v)
    return out.reshape(B, S, H * hd) @ p["wo"]


def init_cache(cfg, batch: int, max_len: int, dtype, device, lead=()):
    """A contiguous KV cache {"k", "v": lead + (batch, max_len, KV, hd)}, zeroed."""
    shape = tuple(lead) + (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg, num_blocks: int, block_size: int, dtype, device, lead=()):
    """A pooled block store {"kp", "vp": lead + (num_blocks, block_size, KV,
    hd)}; block 0 is the scratch block. Zeroed, never left uninitialised:
    masked keys contribute exact zeros only while every slot is finite."""
    shape = tuple(lead) + (num_blocks, block_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}
