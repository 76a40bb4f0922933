"""Top-level model: init / forward / loss / KV caches for the dense family
(port of repro/models/model.py).

Batch keys: tokens (B, S) int64 (required), targets (B, S), loss_mask (B, S),
positions (B, S).
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


def check_ported(cfg) -> None:
    """Raise unless `cfg` is a dense LLaMA the port implements: RMSNorm,
    SwiGLU, rope, full causal attention, no biases, no experts, and no
    activation checkpointing (the reference's ``remat``)."""
    unported = {
        "family": cfg.family != "dense", "norm_type": cfg.norm_type != "rmsnorm",
        "act": cfg.act != "swiglu", "rope_style": cfg.rope_style != "rope",
        "qkv_bias": cfg.qkv_bias, "n_experts": cfg.n_experts > 0,
        "attention_chunk": cfg.attention_chunk > 0, "full_attn_every": cfg.full_attn_every > 0,
        "remat": cfg.remat != "none",
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(f"{cfg.name}: {', '.join(bad)} not ported yet")


def init_params(cfg, seed: int = 0, device=None):
    """Random parameters from `seed`, drawn on `device` (``cuda`` unless given).

    Returns the reference's tree: {"embed", "final_norm", "blocks"} with the
    block leaves stacked (L, …); every leaf requires grad."""
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


PAGED_FAMILIES = ("dense", "moe", "vlm")  # pure-attention caches page cleanly


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
    if positions is None:
        positions = rope_lib.positions_for(cfg, batch, seq, offset, device=device)
    return rope_lib.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)


def forward(cfg, params, batch_dict, *, cache=None, cache_pos=None):
    """Logits (B, S, padded_vocab), f32; with a KV cache see forward_cached."""
    check_ported(cfg)
    tokens = batch_dict["tokens"]
    B, S = tokens.shape
    x = apply_embedding(params["embed"], tokens)
    angles = _angles(cfg, batch_dict.get("positions"), S, B, tokens.device,
                     0 if cache_pos is None else cache_pos)
    x = stacks.apply_decoder_stack(cfg, params["blocks"], x, angles=angles, cache=cache,
                                   cache_pos=cache_pos)
    x = apply_norm(cfg, params["final_norm"], x)
    return apply_unembed(params["embed"], x, cfg.logit_softcap, valid_vocab=cfg.vocab_size)


def forward_cached(cfg, params, batch_dict, *, cache, cache_pos=None):
    """Logits (B, S, padded_vocab) f32 and the cache, written in place.

    Contiguous cache: a prefill (S > 1) writes at 0, a decode step (tokens
    (B, 1)) at `cache_pos`, whose rope phase is cache_pos unless the batch
    carries "positions". Paged cache ({"kp", "vp", "bt", "pos"}): the batch
    carries each row's "positions" (B, S), and K/V go through the block
    tables from each row's "pos"."""
    return forward(cfg, params, batch_dict, cache=cache, cache_pos=cache_pos), cache


def loss_fn(cfg, params, batch_dict, z_loss: float = 0.0):
    """Next-token cross entropy. Returns (loss, metrics): metrics are the
    reference's {"loss", "aux_loss", "ppl_proxy"}, 0-d f32 tensors on the
    loss's device (aux_loss is 0 for the dense family, ppl_proxy is
    exp(min(loss, 20)))."""
    logits = forward(cfg, params, batch_dict).float()
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
    total = loss
    if z_loss > 0:
        total = total + z_loss * (logz.square() * mask).sum() / denom
    loss = loss.detach()
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return total, {"loss": loss, "aux_loss": aux,
                   "ppl_proxy": torch.exp(torch.clamp(loss, max=20.0))}
