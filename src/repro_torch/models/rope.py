"""Rotary position embeddings (port of the standard-RoPE part of repro/models/rope.py)."""
from __future__ import annotations

import torch


def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions (B, S) -> angles (B, S, head_dim//2), f32."""
    inv = _freqs(head_dim, theta, positions.device)
    return positions.float()[..., None] * inv


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), angles (B, S, D//2) -> rotated x (interleaved-half style)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)  # (B, S, 1, D//2)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def positions_for(cfg, batch: int, seq: int, offset: int = 0, device=None) -> torch.Tensor:
    """Default position ids (B, S)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(batch, seq)
