"""Top-level model: init / forward / loss for the dense family (port of
repro/models/model.py).

Batch keys: tokens (B, S) int64 (required), targets (B, S), loss_mask (B, S),
positions (B, S).
"""
from __future__ import annotations

import torch

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


def _angles(cfg, positions, seq, batch, device):
    if positions is None:
        positions = rope_lib.positions_for(cfg, batch, seq, device=device)
    return rope_lib.rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)


def forward(cfg, params, batch_dict):
    """Logits (B, S, padded_vocab), f32."""
    check_ported(cfg)
    tokens = batch_dict["tokens"]
    B, S = tokens.shape
    x = apply_embedding(params["embed"], tokens)
    angles = _angles(cfg, batch_dict.get("positions"), S, B, tokens.device)
    x = stacks.apply_decoder_stack(cfg, params["blocks"], x, angles=angles)
    x = apply_norm(cfg, params["final_norm"], x)
    return apply_unembed(params["embed"], x, cfg.logit_softcap, valid_vocab=cfg.vocab_size)


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
