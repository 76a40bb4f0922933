"""Deterministic synthetic C4-like token pipeline (port of repro/data/pipeline.py).

Same structure as the reference — zipfian unigrams with jitter, a hidden
bigram rule ``next = (prev * mult + 7) % V`` taken with probability 0.8, one
of 16 multipliers per step — drawn from ``torch.Generator``s instead of JAX
keys. The streams are therefore not bitwise equal to JAX's; parity tests hand
JAX batches across through numpy instead.
"""
from __future__ import annotations

import dataclasses
import hashlib

import torch

from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 32000
    seq_len: int = 256
    batch_per_host: int = 8
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _generator(*parts: int) -> torch.Generator:
    """CPU generator seeded from a tuple of ints (the fold_in analogue)."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest[:8], "little"))


class SyntheticC4:
    """Callable pipeline: batch(step) -> {"tokens", "targets", "loss_mask"}.

    A batch is a pure function of (seed, host, step), drawn on the CPU and
    moved to the pipeline's device."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        ranks = torch.arange(1, cfg.vocab_size + 1, dtype=torch.float32)
        jitter = torch.randn(cfg.vocab_size, generator=_generator(cfg.seed, 1))
        self._probs = torch.softmax(-1.1 * torch.log(ranks) + 0.1 * jitter, dim=0)
        self._mults = torch.randint(1, cfg.vocab_size - 1, (16,), generator=_generator(cfg.seed, 2))

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        gen = _generator(cfg.seed, cfg.host_id, step)
        B, S, V = cfg.batch_per_host, cfg.seq_len, cfg.vocab_size
        first = torch.multinomial(self._probs, B, replacement=True, generator=gen)
        noise = torch.multinomial(self._probs, B * S, replacement=True, generator=gen).view(B, S)
        use_struct = torch.rand(B, S, generator=gen) < 0.8
        mult = int(self._mults[step % 16])
        tokens = torch.empty(B, S, dtype=torch.int64)
        tokens[:, 0] = first
        for t in range(1, S):  # position t draws from the inputs at t - 1, as the JAX scan
            structured = (tokens[:, t - 1] * mult + 7) % V
            tokens[:, t] = torch.where(use_struct[:, t - 1], structured, noise[:, t - 1])
        targets = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
        mask = torch.ones(B, S, dtype=torch.float32)
        mask[:, -1] = 0.0
        out = {"tokens": tokens, "targets": targets, "loss_mask": mask}
        return {k: v.to(self.device) for k, v in out.items()}

    def state(self, step: int) -> dict:
        """Checkpointable pipeline state (a batch is a pure function of its
        step, so the position is all there is), saved in META as ``data``."""
        return {"step": step, "seed": self.cfg.seed, "n_hosts": self.cfg.n_hosts}
