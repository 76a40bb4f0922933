"""Paged KV cache: a pooled block store + host-side free-list allocator (the
port's own copy of repro/serve/kv_cache.py).

Device side (allocated once per engine, `models.model.init_paged_cache`):

    kv = {"kp": (L, num_blocks, block_size, KV, hd),
          "vp": (L, num_blocks, block_size, KV, hd)}   in the model's dtype

One global pool shared by every live request — a request's KV lives in
whichever blocks its table names, so device memory scales with *tokens in
flight* (``num_blocks * block_size``), not ``slots * max_len`` as in a
slot-contiguous cache. Block 0 is reserved as a scratch block: inactive
slots and padded positions write there, so the step never needs a
dynamic-shape branch for "this lane is empty".

Host side (`BlockAllocator`): a LIFO free list over block ids
``1..num_blocks-1`` plus per-request block tables. Tables are fixed-width
int32 rows of ``blocks_per_table`` entries (unused tail = 0 → scratch),
because the attention gather needs a static bound; logical length is
tracked per request. `release` returns a request's blocks to the free list
(eviction mid-decode or normal completion — same path).

Invariants (exercised by tests/test_torch_serve.py):
  * block 0 is never handed out;
  * a block id is owned by at most one request at a time;
  * len(free) + sum(owned) == num_blocks - 1 always;
  * release() makes every owned id immediately reusable.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.utils import canonical_dtype


class OutOfBlocks(Exception):
    """Pool exhausted — caller should evict (preempt) someone and retry."""


class BlockAllocator:
    """Free-list allocator over block ids 1..num_blocks-1 (0 = scratch)."""

    def __init__(self, num_blocks: int, block_size: int, blocks_per_table: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is scratch)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.blocks_per_table = blocks_per_table
        # LIFO: recently released blocks are re-handed first, which keeps the
        # hot working set small and makes reuse easy to assert in tests.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}  # request_id -> owned ids
        self._lengths: Dict[int, int] = {}  # request_id -> tokens written
        self.peak_used = 0  # high-water mark of blocks in flight

    # ------------------------------------------------------------- queries
    @property
    def num_free(self) -> int:
        return len(self._free)

    def owned(self, request_id: int) -> List[int]:
        return list(self._tables.get(request_id, ()))

    def length(self, request_id: int) -> int:
        return self._lengths.get(request_id, 0)

    def blocks_needed(self, request_id: int, new_tokens: int) -> int:
        """How many fresh blocks `new_tokens` more tokens would consume."""
        have = len(self._tables.get(request_id, ()))
        total = self._lengths.get(request_id, 0) + new_tokens
        need = -(-total // self.block_size)
        return max(0, need - have)

    def can_append(self, request_id: int, new_tokens: int) -> bool:
        return self.blocks_needed(request_id, new_tokens) <= len(self._free)

    # ----------------------------------------------------------- mutation
    def ensure(self, request_id: int, new_tokens: int) -> None:
        """Grow `request_id`'s table to cover `new_tokens` more tokens.

        All-or-nothing: raises OutOfBlocks without partial allocation, so a
        failed admission never leaks blocks."""
        need = self.blocks_needed(request_id, new_tokens)
        table = self._tables.setdefault(request_id, [])
        if len(table) + need > self.blocks_per_table:
            raise OutOfBlocks(
                f"request {request_id} needs {len(table) + need} blocks "
                f"> table width {self.blocks_per_table} (max_len_cap)")
        if need > len(self._free):
            raise OutOfBlocks(
                f"request {request_id} needs {need} blocks, {len(self._free)} free")
        for _ in range(need):
            table.append(self._free.pop())
        self.peak_used = max(self.peak_used,
                             self.num_blocks - 1 - len(self._free))

    def advance(self, request_id: int, new_tokens: int) -> None:
        """Record `new_tokens` tokens actually written (after ensure())."""
        self._lengths[request_id] = self._lengths.get(request_id, 0) + new_tokens
        assert self._lengths[request_id] <= len(self._tables[request_id]) * self.block_size

    def release(self, request_id: int) -> int:
        """Return all of `request_id`'s blocks to the free list."""
        blocks = self._tables.pop(request_id, [])
        self._lengths.pop(request_id, None)
        self._free.extend(blocks)
        return len(blocks)

    # ------------------------------------------------------- device views
    def table_row(self, request_id: int) -> np.ndarray:
        """Fixed-width int32 block-table row (unused tail -> 0 = scratch)."""
        row = np.zeros((self.blocks_per_table,), np.int32)
        blocks = self._tables.get(request_id, ())
        row[: len(blocks)] = blocks
        return row

    def check_invariants(self) -> None:
        """Debug/test hook: assert pool accounting is consistent."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate id on free list"
        assert 0 not in free, "scratch block leaked onto free list"
        owned: set = set()
        for rid, blocks in self._tables.items():
            bs = set(blocks)
            assert len(bs) == len(blocks), f"request {rid} holds duplicate ids"
            assert 0 not in bs, f"request {rid} owns scratch block"
            assert not (bs & owned), "block owned by two requests"
            owned |= bs
        assert not (free & owned), "block both free and owned"
        assert len(free) + len(owned) == self.num_blocks - 1, "blocks leaked"


def _itemsize(cfg) -> int:
    return canonical_dtype(cfg.dtype).itemsize


def pool_bytes(cfg, num_blocks: int, block_size: int) -> int:
    """Analytic device footprint of the paged pool (K + V in the model's
    dtype: 2 bytes an element for bf16; the reference counts 4 whatever the
    dtype)."""
    hd = cfg.resolved_head_dim
    return 2 * cfg.n_layers * num_blocks * block_size * cfg.n_kv_heads * hd * _itemsize(cfg)


def slot_cache_bytes(cfg, slots: int, max_len: int) -> int:
    """Analytic device footprint of a slot-contiguous cache (K + V in the
    model's dtype)."""
    hd = cfg.resolved_head_dim
    return 2 * cfg.n_layers * slots * max_len * cfg.n_kv_heads * hd * _itemsize(cfg)
