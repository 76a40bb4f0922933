"""Grouped-query attention with its KV caches (port of
repro/models/attention.py::attend, ``_paged_attend``, ``init_cache`` and
``init_paged_cache``): GQA and MQA, QKV biases, rope or none (the rope-free
global layer of iRoPE), causal and chunked-local masks, the bidirectional
encoder (no mask) and cross-attention over precomputed encoder K/V.

Plain tensor ops as the reference is plain jnp — no fused attention operator,
which would change the numerics: scores are computed and masked in f32
(``NEG_INF`` applied in f32), the softmax subtracts a detached row max, and
the probabilities are cast back to V's dtype for the value product.

Caches are written in place (the reference's donated ``.at[].set``): a
contiguous cache {"k", "v": (B, T, KV, hd)} at 0 by a prefill (S > 1) or at
``cache_pos`` by a decode step (S == 1); a paged one {"kp", "vp": (NB, bs, KV,
hd) pooled blocks, "bt": (B, nb) block tables, "pos": (B,) next write index}
through the block table.

Without a cache the core (mask, QKᵀ, softmax, PV) is one function, which
remat "scores" recomputes in the backward; q, k, v and the context pass
through ``remat.name`` where the reference names them (models/remat.py).

Where the reference differs: its contiguous decode step of a chunked layer
takes a static window of ``chunk`` keys with ``dynamic_slice``, which clamps
the window's start into the cache while its mask keeps the unclamped start,
so it is wrong whenever the cache length is not a multiple of the chunk (and
raises when the cache is shorter than the chunk; ROADMAP C.12). Here the
window is the chunk of ``cache_pos`` cut to the cache, and the mask is taken
at the window's own key positions.
"""
from __future__ import annotations

import torch

from repro_torch.models import remat
from repro_torch.models import rope as rope_lib
from repro_torch.models.layers import _init_normal, dense
from repro_torch.utils import logical_constraint

NEG_INF = -2.3819763e38  # large negative for bf16-safe masking (applied in f32)


def init_attention(gen, cfg, dtype, lead=(), cross: bool = False):
    """{"wq", "wk", "wv", "wo"}, and the QKV biases under cfg.qkv_bias —
    never for cross-attention (`cross`), as in the reference."""
    lead = tuple(lead)
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    p = {
        "wq": _init_normal(gen, lead + (d, cfg.n_heads * hd), dtype, fan_in=d),
        "wk": _init_normal(gen, lead + (d, cfg.n_kv_heads * hd), dtype, fan_in=d),
        "wv": _init_normal(gen, lead + (d, cfg.n_kv_heads * hd), dtype, fan_in=d),
        "wo": _init_normal(gen, lead + (cfg.n_heads * hd, d), dtype, fan_in=cfg.n_heads * hd),
    }
    if cfg.qkv_bias and not cross:
        dev = gen.device
        p["bq"] = torch.zeros(lead + (cfg.n_heads * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros(lead + (cfg.n_kv_heads * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(lead + (cfg.n_kv_heads * hd,), dtype=dtype, device=dev)
    return p


def attention_axes(cfg, cross: bool = False):
    """Logical axes of one attention layer's parameters (the reference's)."""
    ax = {"wq": ("embed", "heads_flat"), "wk": ("embed", "kv_flat"),
          "wv": ("embed", "kv_flat"), "wo": ("heads_flat", "embed")}
    if cfg.qkv_bias and not cross:
        ax.update(bq=("heads_flat",), bk=("kv_flat",), bv=("kv_flat",))
    return ax


def _proj(x, w, b, n_heads, hd):
    y = dense(x, w)
    if b is not None:
        y = y + b
    # on a mesh the projection comes back sequence-sharded (the reference's
    # sequence parallelism), so a head count the model axis does not divide
    # (28 heads on 16) splits into heads on every rank
    y = logical_constraint(y, "batch", "act_seq", None)
    return y.reshape(x.shape[0], x.shape[1], n_heads, hd)


def _ctx(out, B, S):
    """The attention's context (B, S, KV, G, hd) as (B, S, H·hd). On a mesh
    its heads are whole before and after they are merged (the sequence
    gathered for wo, as every projection's input is), so the gradient that
    comes back through wo is split into heads whole (4 KV heads on a
    16-way axis cannot be split)."""
    out = logical_constraint(out, "batch", None, None, None, None)
    return logical_constraint(out.reshape(B, S, -1), "batch", None, None)


def _gqa_scores(q, k):
    """q (B,S,K,G,hd), k (B,T,K,hd) -> (B,K,G,S,T) f32 (f32 accumulation and
    output, as ``preferred_element_type=f32`` in the reference)."""
    return torch.einsum("bskgh,btkh->bkgst", q.float(), k.float())


def _gqa_out(probs, v):
    """probs (B,K,G,S,T), v (B,T,K,hd) -> (B,S,K,G,hd)."""
    return torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype), v)


def _masked_softmax(scores, mask):
    """Softmax over the last axis of f32 `scores` (which it may overwrite),
    masked keys at NEG_INF; `mask` None masks nothing. Without autograd it
    runs in place in `scores`, the same values in one buffer (a serving
    prefill's scores are H·S·T·4 bytes a layer: 12 GB at Scout's 40 heads
    and 8,704 tokens)."""
    if not torch.is_grad_enabled():
        if mask is not None:
            scores.masked_fill_(~mask, NEG_INF)
        scores.sub_(scores.amax(dim=-1, keepdim=True)).exp_()
        return scores.div_(scores.sum(dim=-1, keepdim=True))
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True).detach()
    unnorm = torch.exp(scores - m)
    return unnorm / unnorm.sum(dim=-1, keepdim=True)


def _chunk_mask(qi, kj, chunk: int):
    """Key j visible from query i: causal, and in i's chunk when chunk > 0."""
    mask = kj <= qi
    if chunk > 0:
        mask = mask & ((qi // chunk) == (kj // chunk))
    return mask


def _paged_attend(q, k, v, cache, chunk: int = 0):
    """Block-table attention over a pooled paged KV cache (the serving engine).

    Write: this call's S tokens go to flat pool slots through the block table.
    Read: each row gathers its nb blocks back into position order, T = nb·bs
    keys, masked causally (and by chunk) against the row's own positions,
    which are absolute, so chunk boundaries fall where they fall in the full
    forward whatever the block layout. Masked keys (stale,
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
    mask = _chunk_mask(tgt[:, :, None], kj[None, None, :], chunk)  # (B, S, T)
    probs = _masked_softmax(_gqa_scores(q, k_att), mask[:, None, None])
    return _gqa_out(probs, v_att)


def attend(cfg, p, x, *, angles, causal: bool = True, chunk: int = 0, cache=None,
           cache_pos=None, kv_override=None):
    """Self-attention over x (B, S, D), causal unless `causal` is False (the
    encoder's: every key visible); returns (B, S, D).

    `angles` None applies no rope. `chunk` > 0 lets a query see only the
    keys of its own chunk of positions (chunked-local attention). With a
    contiguous `cache` a prefill (S > 1) writes its K/V at 0 and attends
    within itself, a decode step (S == 1) writes at `cache_pos` (an int) and
    attends over the cache up to it — a chunked layer over the chunk of
    `cache_pos` only; a paged `cache` (``"kp"`` in it) writes and reads
    through its block tables (``_paged_attend``). The cache is written in
    place. `kv_override` = (k, v), each (B, T, KV, hd), is cross-attention:
    the queries attend to those keys, every one visible at any S, with no
    rope and no cache."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    G = H // KV
    q = _proj(x, p["wq"], p.get("bq"), H, hd)
    if kv_override is not None:  # cross-attention: learned positions, no rope
        k, v = kv_override
        q = q.reshape(B, S, KV, G, hd) * (hd ** -0.5)
        out = remat.scores_core(_core_fn(False, 0), q, k, v)
        return dense(remat.name(_ctx(out, B, S), "save_attn_ctx"), p["wo"], "residual")
    k = _proj(x, p["wk"], p.get("bk"), KV, hd)
    v = _proj(x, p["wv"], p.get("bv"), KV, hd)
    if angles is not None:
        q = rope_lib.apply_rotary(q, angles)
        k = rope_lib.apply_rotary(k, angles)
    q, k, v = remat.name(q, "save_q"), remat.name(k, "save_k"), remat.name(v, "save_v")
    # the reference constrains q so where G == 1; on DTensor every G (the
    # scores' product flattens (G, S), which a sharded S blocks)
    q = logical_constraint(q, "batch", None, "kv_heads", None)
    q = q.reshape(B, S, KV, G, hd) * (hd ** -0.5)
    if cache is not None and "kp" in cache:
        out = _paged_attend(q, k, v, cache, chunk)
    elif cache is not None and S == 1:
        cache["k"][:, cache_pos] = k[:, 0]
        cache["v"][:, cache_pos] = v[:, 0]
        lo, hi = 0, cache["k"].shape[1]
        if chunk > 0:  # the chunk of cache_pos, cut to the cache
            lo = (cache_pos // chunk) * chunk
            hi = min(lo + chunk, hi)
        valid = torch.arange(lo, hi, device=x.device) <= cache_pos
        k_att, v_att = cache["k"][:, lo:hi], cache["v"][:, lo:hi]
        probs = _masked_softmax(_gqa_scores(q, k_att), valid[None, None, None, None, :])
        out = _gqa_out(probs, v_att)
    else:
        if cache is not None:  # prefill: the whole prefix at 0
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
        out = remat.scores_core(_core_fn(causal, chunk), q, k, v)
    return dense(remat.name(_ctx(out, B, S), "save_attn_ctx"), p["wo"], "residual")


def _core_fn(causal: bool, chunk: int):
    """The attention core over a whole sequence, (q, k, v) -> (B,S,K,G,hd):
    the mask (causal over the S positions q and k share, by `chunk`; none
    for the bidirectional encoder and cross-attention), QKᵀ in f32, the
    softmax, PV. The mask is made inside, so that remat "scores" recomputes
    it rather than keep it."""
    def core(q, k, v):
        mask = None
        if causal:
            pos = torch.arange(q.shape[1], device=q.device)
            mask = _chunk_mask(pos[:, None], pos[None, :], chunk)[None, None, None]
        return _gqa_out(_masked_softmax(_gqa_scores(q, k), mask), v)
    return core


def init_cache(cfg, batch: int, max_len: int, dtype, device, lead=()):
    """A contiguous KV cache {"k", "v": lead + (batch, max_len, KV, hd)}, zeroed."""
    shape = tuple(lead) + (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_axes():
    """Logical axes of a layer's contiguous cache (the reference's): the
    sequence can be context-sharded."""
    spec = ("batch", "kv_seq", "kv_heads", None)
    return {"k": spec, "v": spec}


def init_paged_cache(cfg, num_blocks: int, block_size: int, dtype, device, lead=()):
    """A pooled block store {"kp", "vp": lead + (num_blocks, block_size, KV,
    hd)}; block 0 is the scratch block. Zeroed, never left uninitialised:
    masked keys contribute exact zeros only while every slot is finite."""
    shape = tuple(lead) + (num_blocks, block_size, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}
