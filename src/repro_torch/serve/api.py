"""Typed request/response surface of the serving engine (the port's own copy
of repro/serve/api.py: the reference's serve package imports JAX).

Everything a client touches is one of three dataclasses:

  ServeConfig — server-wide engine knobs (block pool size, slot count,
                prefill chunking). Note max_len is NOT here: with the paged
                KV cache a request's context ceiling is a per-request
                property (`Request.max_len`); the server-wide numbers are
                the shared block POOL (num_blocks × block_size tokens across
                all live requests) and `max_len_cap`, the static width of
                the per-slot block table (the compile-time gather bound).
  Request     — one generation job: prompt tokens + per-request decode
                budget (`max_new`), context ceiling (`max_len`) and sampling
                params (temperature 0 = greedy).
  Completion  — the finished result: generated tokens, finish reason and
                timing (submit → first token → done) for latency accounting.

The engine consumes/produces these via `Engine.submit()` / `Engine.poll()`
/ `Engine.run_until_drained()` (serve/engine.py); the legacy
`Server.generate(prompts)` API is a deprecated shim over them
(launch/serve.py).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence

_REQ_IDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine-wide configuration (per-request knobs live on Request)."""

    block_size: int = 16  # tokens per KV block
    num_blocks: int = 512  # total pooled blocks (block 0 is the scratch block)
    slots: int = 4  # concurrent decode lanes (the decode batch dim)
    max_len_cap: int = 512  # hard ceiling on any request's prompt+generation
    # length; fixes the block-table width nb = ceil(cap / block_size), the
    # static gather bound of the paged attention read
    prefill_chunk: int = 32  # prompt tokens prefilled per scheduler turn —
    # long prompts are fed chunk-by-chunk, interleaved with decode steps, so
    # a 32k prompt never stalls the other slots' token streams
    default_max_new: int = 16  # Request.max_new fallback

    @property
    def blocks_per_table(self) -> int:
        """Block-table width: ``ceil(max_len_cap / block_size)`` slots."""
        return -(-self.max_len_cap // self.block_size)

    def __post_init__(self):
        if self.block_size < 1 or self.num_blocks < 2:
            raise ValueError("need block_size >= 1 and num_blocks >= 2 "
                             "(block 0 is reserved as scratch)")
        if self.slots < 1:
            raise ValueError("need at least one decode slot")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation job. `tokens` is the prompt (ints in [0, vocab))."""

    tokens: tuple
    max_new: Optional[int] = None  # decode budget; None -> ServeConfig default
    max_len: Optional[int] = None  # per-request context ceiling
    # (prompt + generated); None -> the server's max_len_cap. Generation
    # stops with finish_reason="length" when the total hits it.
    temperature: float = 0.0  # 0 -> greedy argmax
    top_k: int = 0  # >0: sample only among the k most likely tokens
    seed: int = 0  # per-request sampling stream (temperature > 0)
    request_id: int = dataclasses.field(default_factory=lambda: next(_REQ_IDS))

    def __post_init__(self):
        object.__setattr__(self, "tokens", tuple(int(t) for t in self.tokens))
        if not self.tokens:
            raise ValueError("empty prompt")
        if self.max_new is not None and self.max_new < 1:
            raise ValueError("max_new must be >= 1")
        if self.max_len is not None and self.max_len <= len(self.tokens):
            raise ValueError(
                f"max_len={self.max_len} leaves no room to generate beyond "
                f"the {len(self.tokens)}-token prompt")


def make_request(tokens: Sequence[int], **kw) -> Request:
    """Convenience constructor accepting any int sequence (numpy or torch too)."""
    return Request(tokens=tuple(int(t) for t in tokens), **kw)


@dataclasses.dataclass(frozen=True)
class Completion:
    """A finished (or failed) request."""

    request_id: int
    prompt_len: int
    tokens: tuple  # generated tokens, prompt excluded
    finish_reason: str  # "max_new" | "length" | "error"
    submitted_at: float = 0.0  # engine clock timestamps (time.monotonic)
    first_token_at: float = 0.0
    finished_at: float = 0.0
    preemptions: int = 0  # times this request was evicted for pool space
    # and re-prefilled from scratch (recompute preemption)

    @property
    def latency_s(self) -> float:
        """End-to-end seconds from submit to the last generated token."""
        return self.finished_at - self.submitted_at

    @property
    def ttft_s(self) -> float:
        """Time to first token (queue wait + prefill)."""
        return self.first_token_at - self.submitted_at
