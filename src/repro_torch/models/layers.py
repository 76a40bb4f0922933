"""Primitive layers: RMSNorm, dense projections, embeddings, the SwiGLU MLP.

Port of the dense-LLaMA part of repro/models/layers.py. Parameters are plain
dicts of tensors in the reference layout — dense kernels (d_in, d_out),
embeddings (vocab, d_model). Dtype handling follows the reference op for op:
the norm computes in f32 and casts back, dense products run in the parameter
dtype, logits come out f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _init_normal(gen: torch.Generator, shape, dtype, fan_in=None) -> torch.Tensor:
    scale = (fan_in or shape[0]) ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(dtype)


def init_norm(cfg, dtype, device, lead=()):
    return {"scale": torch.ones(tuple(lead) + (cfg.d_model,), dtype=dtype, device=device)}


def apply_norm(cfg, p, x, eps=1e-6):
    """RMSNorm in f32, cast back to x's dtype."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"].float()).to(x.dtype)


def apply_dense(p, x):
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def init_embedding(gen, vocab, d_model, dtype):
    emb = _init_normal(gen, (vocab, d_model), torch.float32, fan_in=d_model)
    return {"embedding": emb.to(dtype)}


def apply_embedding(p, tokens):
    return F.embedding(tokens, p["embedding"])


def apply_unembed(p, x, softcap: float = 0.0, valid_vocab: int = 0):
    """Logits from the tied embedding head, f32. Pad-vocab columns are masked
    to -1e30."""
    logits = (x @ p["embedding"].transpose(0, 1)).float()
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    padded = p["embedding"].shape[0]
    if valid_vocab and valid_vocab < padded:
        col = torch.arange(padded, device=logits.device)
        logits = torch.where(col < valid_vocab, logits, torch.full_like(logits, -1e30))
    return logits


def init_mlp(gen, cfg, dtype, lead=()):
    lead = tuple(lead)
    d, f = cfg.d_model, cfg.d_ff
    return {
        "gate": _init_normal(gen, lead + (d, f), dtype, fan_in=d),
        "up": _init_normal(gen, lead + (d, f), dtype, fan_in=d),
        "down": _init_normal(gen, lead + (f, d), dtype, fan_in=f),
    }


def apply_mlp(cfg, p, x):
    """SwiGLU: (silu(x W_gate) * x W_up) W_down."""
    return (F.silu(x @ p["gate"]) * (x @ p["up"])) @ p["down"]
