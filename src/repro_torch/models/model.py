"""Top-level model: init / forward / loss / KV caches for the token-decoder
families (port of repro/models/model.py).

Families: dense | moe | vlm, through one decoder stack (models/stacks.py);
vlm mixes precomputed patch embeddings (the stubbed vision frontend) into the
first positions. The recurrent and encoder-decoder families (ssm, hybrid,
audio) are not ported yet (ROADMAP A.11b).

Batch keys: tokens (B, S) int64 (required), targets (B, S), loss_mask (B, S),
positions (B, S), or (3, B, S) under M-RoPE, media (B, M, D).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn_lib
from repro_torch.models import rope as rope_lib
from repro_torch.models import stacks
from repro_torch.models.layers import (
    apply_embedding,
    apply_norm,
    apply_unembed,
    init_embedding,
    init_norm,
)
from repro_torch.utils import canonical_dtype, resolve_device, tree_map


PAGED_FAMILIES = ("dense", "moe", "vlm")  # pure-attention caches page cleanly


def check_ported(cfg) -> None:
    """Raise unless the port implements `cfg`: a dense, MoE or vlm decoder
    with RMSNorm and SwiGLU, and activation checkpointing "none" or "full".
    Not ported: the ssm, hybrid and audio families, LayerNorm, GELU, and the
    reference's remat policies "scores" and "names" (used by its TPU
    hill-climbing tool only)."""
    unported = {
        "family": cfg.family not in PAGED_FAMILIES, "norm_type": cfg.norm_type != "rmsnorm",
        "act": cfg.act != "swiglu", "remat": cfg.remat not in ("none", "full"),
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.name}: {', '.join(bad)} not ported yet")


def init_params(cfg, seed: int = 0, device=None):
    """Random parameters from `seed`, drawn on `device` (``cuda`` unless given).

    Returns the reference's tree: {"embed", "final_norm", "blocks"} with the
    block leaves stacked (L, …) — MoE expert leaves (L, E, …), the router f32
    in any model dtype; every leaf requires grad."""
    check_ported(cfg)
    device = resolve_device(device)
    dtype = canonical_dtype(cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = {
        "embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "final_norm": init_norm(cfg, dtype, device),
        "blocks": stacks.init_decoder_stack(gen, cfg, dtype),
    }
    return tree_map(lambda t: t.requires_grad_(True), p)


def init_cache(cfg, batch: int, max_len: int, device=None):
    """Stacked contiguous KV cache {"k", "v": (L, batch, max_len, KV, hd)} in
    the model's dtype, zeroed, on `device` (``cuda`` unless given)."""
    check_ported(cfg)
    return attn_lib.init_cache(cfg, batch, max_len, canonical_dtype(cfg.dtype),
                               resolve_device(device), lead=(cfg.n_layers,))


def init_paged_cache(cfg, num_blocks: int, block_size: int, device=None):
    """Stacked pooled KV blocks {"kp", "vp": (L, NB, bs, KV, hd)} in the
    model's dtype, zeroed, on `device` (``cuda`` unless given).

    One pool shared by every live request of the serving engine; per-request
    block tables and positions are supplied per call by the paged steps
    (distributed/step.py), not stored here."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"paged KV cache supports families {PAGED_FAMILIES}, not "
            f"{cfg.family!r} (recurrent/cross-attn state is not paged)")
    check_ported(cfg)
    return attn_lib.init_paged_cache(cfg, num_blocks, block_size, canonical_dtype(cfg.dtype),
                                     resolve_device(device), lead=(cfg.n_layers,))


def _angles(cfg, positions, seq, batch, device, offset=0):
    """Rope angles (B, S, hd/2) f32 from the batch's positions (or the
    default ones from `offset`), M-RoPE's from (3, B, S) positions; None for
    rope_style "none"."""
    if cfg.rope_style == "none":
        return None
    hd = cfg.resolved_head_dim
    if positions is None:
        positions = rope_lib.positions_for(cfg, batch, seq, offset, device=device)
    if cfg.rope_style == "mrope":
        return rope_lib.mrope_angles(positions, hd, cfg.rope_theta, cfg.mrope_sections)
    return rope_lib.rope_angles(positions, hd, cfg.rope_theta)


def _embed_inputs(cfg, params, batch_dict):
    """Token embeddings; under a media frontend (vlm) the first M positions
    carry the batch's precomputed media embeddings (B, M, D) instead."""
    x = apply_embedding(params["embed"], batch_dict["tokens"])
    media = batch_dict.get("media")
    if media is not None and cfg.media_embeds > 0:
        M_ = media.shape[1]
        x = torch.cat([media.to(x.dtype), x[:, M_:]], dim=1)
    return x


def forward_with_aux(cfg, params, batch_dict, *, cache=None, cache_pos=None):
    """(logits (B, S, padded_vocab) f32, aux_loss 0-d f32): the MoE layers'
    load-balancing loss summed, 0 without experts."""
    check_ported(cfg)
    tokens = batch_dict["tokens"]
    B, S = tokens.shape
    x = _embed_inputs(cfg, params, batch_dict)
    angles = _angles(cfg, batch_dict.get("positions"), S, B, tokens.device,
                     0 if cache_pos is None else cache_pos)
    x, aux = stacks.apply_decoder_stack(cfg, params["blocks"], x, angles=angles, cache=cache,
                                        cache_pos=cache_pos)
    x = apply_norm(cfg, params["final_norm"], x)
    return apply_unembed(params["embed"], x, cfg.logit_softcap, valid_vocab=cfg.vocab_size), aux


def forward(cfg, params, batch_dict, *, cache=None, cache_pos=None):
    """Logits (B, S, padded_vocab), f32; with a KV cache see forward_cached."""
    return forward_with_aux(cfg, params, batch_dict, cache=cache, cache_pos=cache_pos)[0]


def forward_cached(cfg, params, batch_dict, *, cache, cache_pos=None):
    """Logits (B, S, padded_vocab) f32 and the cache, written in place.

    Contiguous cache: a prefill (S > 1) writes at 0, a decode step (tokens
    (B, 1)) at `cache_pos`, whose rope phase is cache_pos unless the batch
    carries "positions". Paged cache ({"kp", "vp", "bt", "pos"}): the batch
    carries each row's "positions" (B, S) — (3, B, S) under M-RoPE — and K/V
    go through the block tables from each row's "pos"."""
    return forward(cfg, params, batch_dict, cache=cache, cache_pos=cache_pos), cache


def loss_fn(cfg, params, batch_dict, z_loss: float = 0.0):
    """Next-token cross entropy plus the MoE load-balancing loss. Returns
    (total, metrics): metrics are the reference's {"loss", "aux_loss",
    "ppl_proxy"}, 0-d f32 tensors on the loss's device ("loss" the cross
    entropy alone, aux_loss 0 without experts, ppl_proxy
    exp(min(loss, 20)))."""
    logits, aux = forward_with_aux(cfg, params, batch_dict)
    logits = logits.float()
    tokens = batch_dict["tokens"]
    targets = batch_dict.get("targets")
    if targets is None:
        targets = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    mask = batch_dict.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32, device=logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (logz - tgt_logit) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    total = loss + aux
    if z_loss > 0:
        total = total + z_loss * (logz.square() * mask).sum() / denom
    loss = loss.detach()
    return total, {"loss": loss, "aux_loss": aux.detach(),
                   "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}
