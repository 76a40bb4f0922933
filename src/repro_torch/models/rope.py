"""Rotary position embeddings: standard RoPE and multimodal M-RoPE (Qwen2-VL)
(port of repro/models/rope.py).

M-RoPE splits the head_dim/2 frequency slots into (temporal, height, width)
sections; each section consumes the corresponding row of a (3, B, S) position
tensor. For pure-text positions all three rows are equal, which makes M-RoPE
collapse to standard RoPE (the Qwen2-VL property).
"""
from __future__ import annotations

import torch


def _freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """positions (B, S) -> angles (B, S, head_dim//2), f32."""
    inv = _freqs(head_dim, theta, positions.device)
    return positions.float()[..., None] * inv


def mrope_angles(positions: torch.Tensor, head_dim: int, theta: float, sections) -> torch.Tensor:
    """positions (3, B, S) -> angles (B, S, head_dim//2), f32: frequency slot
    j takes its angle from the position row of the section it lies in."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to {half}")
    inv = _freqs(head_dim, theta, positions.device)
    section_id = torch.repeat_interleave(torch.arange(len(sections), device=positions.device),
                                         torch.tensor(sections, device=positions.device),
                                         output_size=half)
    all_angles = positions.float()[..., None] * inv  # (3, B, S, half)
    return torch.gather(all_angles, 0, section_id.expand(all_angles.shape[1:])[None])[0]


def apply_rotary(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D), angles (B, S, D//2) -> rotated x (interleaved-half style)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    cos = torch.cos(angles)[..., None, :].to(x.dtype)  # (B, S, 1, D//2)
    sin = torch.sin(angles)[..., None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def positions_for(cfg, batch: int, seq: int, offset: int = 0, device=None) -> torch.Tensor:
    """Default position ids: (B, S) for rope, (3, B, S) for mrope."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    if cfg.rope_style == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos
