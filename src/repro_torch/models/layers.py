"""Primitive layers: RMSNorm and LayerNorm, dense projections, embeddings,
the SwiGLU and GELU MLPs.

Port of repro/models/layers.py. Parameters are plain dicts of tensors in the
reference layout — dense kernels (d_in, d_out), embeddings (vocab, d_model).
Dtype handling follows the reference op for op: the norms compute in f32 and
cast back, dense products run in the parameter dtype, logits come out f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import remat
from repro_torch.utils import logical_constraint


class MetaGenerator:
    """What ``init_params`` draws from on the meta device, where torch has no
    generator: it stands for one, and the init draws nothing from it."""

    device = torch.device("meta")


def _init_normal(gen: torch.Generator, shape, dtype, fan_in=None) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = (fan_in or shape[0]) ** -0.5
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(dtype)


def init_norm(cfg, dtype, device, lead=()):
    shape = tuple(lead) + (cfg.d_model,)
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def apply_norm(cfg, p, x, eps=1e-6):
    """RMSNorm, or LayerNorm ((x − mean)·rsqrt(var + eps)·scale + bias, the
    variance the mean of the squared deviations, as the reference writes it;
    ``F.layer_norm`` computes it another way), in f32, cast back to x's
    dtype."""
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + eps)
        return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)
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
    logits = dense(x, p["embedding"].transpose(0, 1)).float()
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    padded = p["embedding"].shape[0]
    if valid_vocab and valid_vocab < padded:
        col = torch.arange(padded, device=logits.device)
        logits = torch.where(col < valid_vocab, logits, torch.full_like(logits, -1e30))
    return logits


def init_mlp(gen, cfg, dtype, lead=(), d_ff=None):
    """{"gate", "up", "down"} for SwiGLU; {"up", "down"} for GELU."""
    lead = tuple(lead)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"gate": _init_normal(gen, lead + (d, f), dtype, fan_in=d)} if cfg.act == "swiglu" else {}
    p["up"] = _init_normal(gen, lead + (d, f), dtype, fan_in=d)
    p["down"] = _init_normal(gen, lead + (f, d), dtype, fan_in=f)
    return p


def dense(x, w, out=None):
    """x (B, S, d) @ w (d, f). On a mesh the activation's sequence is gathered
    first, the all-gather before a projection of the reference's sequence
    parallelism: the product flattens (B, S), which DTensor cannot do to a
    sequence-sharded tensor on every torch version. `out` ("residual") puts
    the product back on the sequence, as the residual stream it joins is, so
    the gradient it gets back is converted before the product's backward
    flattens it."""
    if x.ndim != 3:
        return x @ w
    y = logical_constraint(x, "batch", None, None) @ w
    return logical_constraint(y, "batch", "act_seq", None) if out == "residual" else y


def apply_mlp(cfg, p, x):
    """SwiGLU: (silu(x W_gate) * x W_up) W_down; GELU: gelu(x W_up) W_down
    with the tanh form, ``jax.nn.gelu``'s default (the exact erf form differs
    from it by up to 4.7e-4). The hidden is remat "names"'s save_ffn_hidden."""
    if cfg.act == "swiglu":
        h = F.silu(dense(x, p["gate"])) * dense(x, p["up"])
    else:
        h = F.gelu(dense(x, p["up"]), approximate="tanh")
    h = logical_constraint(h, "batch", None, "ff")
    return dense(remat.name(h, "save_ffn_hidden"), p["down"], "residual")


# Logical axis labels of the parameters (the reference's ``*_axes``): plain
# tuples of strings, read by core/subspace.py's tp_aware_side and ZeRO maps.


def norm_axes(cfg):
    if cfg.norm_type == "layernorm":
        return {"scale": ("embed",), "bias": ("embed",)}
    return {"scale": ("embed",)}


def dense_axes(bias=False, axes=("embed", "ff")):
    ax = {"kernel": axes}
    if bias:
        ax["bias"] = (axes[1],)
    return ax


def embedding_axes():
    return {"embedding": ("vocab", None)}


def mlp_axes(cfg):
    if cfg.act == "swiglu":
        return {"gate": ("embed", "ff"), "up": ("embed", "ff"), "down": ("ff", "embed")}
    return {"up": ("embed", "ff"), "down": ("ff", "embed")}
