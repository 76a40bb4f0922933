"""Continuous-batching scheduler over the paged KV cache (port of
repro/serve/engine.py).

One `Engine` owns the device state (params + the pooled block cache) and a
host-side scheduler. Each scheduler iteration (`step()`):

  1. **admit** — move queued requests into free decode slots (after a
     feasibility check: a request whose full trajectory can never fit the
     pool or the block-table width completes immediately as "error");
  2. **prefill one chunk per pending slot** — every admitted-but-
     unprefilled lane advances by at most `prefill_chunk` prompt tokens in
     ONE batched paged-prefill call (per-lane pos0). Chunking bounds how
     long a huge prompt can stall decode: at most one chunk between decode
     batches. When a lane's last chunk lands, its first output token is
     sampled from that chunk's logits (only those rows cross to the host);
  3. **decode one token** — a single batched paged-decode call over ALL
     slots (inactive lanes ride along against scratch block 0). While the
     active lane set is stable and all-greedy, the step's fused on-device
     argmax feeds the next step directly (no per-token host sync; values
     materialise lazily — finish checks are count-based). Sampled lanes
     (temperature+top_k, seeded) fall back to host-side sampling on the
     returned logits. Finish checks (`max_new`, per-request `max_len`)
     release finished slots' blocks back to the free list mid-batch.

Admission and eviction are per-slot — a finishing request frees its slot
and blocks while its batchmates keep decoding, and the next queued request
takes over the lane on the following iteration. When the pool runs dry
mid-decode, the youngest slot is preempted by RECOMPUTE: its blocks are
released and (prompt + generated-so-far) re-enters the queue front as the
prefix of a fresh prefill — greedy output is unchanged (the re-prefilled
logits equal the decode logits; see models/attention._paged_attend).

The device state lives on the params' device. The pool is written in place
by each step (the reference donates it to its jitted steps). Host arrays
cross to a CUDA device from pinned memory without blocking, so a greedy
decode step never waits for the device; token values cross back lazily
(`_flush_deferred`, one device→host copy per deferred step).

Thread story: `submit()`/`poll()` are non-blocking and thread-safe;
`step()` holds the engine lock, so either drive the engine inline with
`run_until_drained()` or call `start()` once and let the background
scheduler thread spin — both paths execute the same iteration.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.step import make_paged_decode_step, make_paged_prefill_step
from repro_torch.models import model as M
from repro_torch.serve.api import Completion, Request, ServeConfig
from repro_torch.serve.kv_cache import BlockAllocator, OutOfBlocks, pool_bytes
from repro_torch.utils import tree_leaves


class _Work:
    """Scheduler-internal state of one admitted/queued request."""

    __slots__ = ("req", "tokens", "generated", "prefilled", "pending",
                 "submitted_at", "first_token_at", "preemptions", "rng")

    def __init__(self, req: Request, now: float):
        self.req = req
        self.tokens = list(req.tokens)  # prefill prefix (prompt; after a
        # preemption: prompt + generated so far, recomputed from scratch)
        self.generated: List[int] = []
        self.prefilled = 0  # tokens of self.tokens already written to cache
        self.pending = 0  # emitted tokens still device-resident (fast path)
        self.submitted_at = now
        self.first_token_at: Optional[float] = None
        self.preemptions = 0
        self.rng = (np.random.default_rng(req.seed)
                    if req.temperature > 0 else None)

    @property
    def n_generated(self) -> int:
        return len(self.generated) + self.pending

    def reset_for_requeue(self):
        self.tokens = list(self.req.tokens) + self.generated
        self.prefilled = 0
        self.preemptions += 1


class Engine:
    """Paged-cache continuous-batching engine for the families whose cache
    pages (``model.PAGED_FAMILIES``: dense, moe, vlm — chunked attention
    masked by absolute position, M-RoPE with text positions). Runs on the
    device of `params`."""

    def __init__(self, cfg, params, serve_cfg: Optional[ServeConfig] = None):
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg or ServeConfig()
        s = self.scfg
        self.device = tree_leaves(params)[0].device
        self.alloc = BlockAllocator(s.num_blocks, s.block_size, s.blocks_per_table)
        self.kv = M.init_paged_cache(cfg, s.num_blocks, s.block_size, device=self.device)
        self._prefill = make_paged_prefill_step(cfg)
        raw_decode = make_paged_decode_step(cfg)

        def _decode_fused(params, kv, bt, pos, toks):
            logits, kv = raw_decode(params, kv, bt, pos, toks)
            return logits, logits.argmax(dim=-1)[:, None], kv

        self._decode = _decode_fused
        # steady-state greedy fast path: while the active lane set is stable
        # and all-greedy, the decode step's own argmax (`_dev_toks`) feeds the
        # next step directly on device — no per-token host sync. Token VALUES
        # are materialised lazily (`_flush_deferred`); finish checks only need
        # counts, and the first token of every request is host-sampled in
        # `_prefill_turn`, so TTFT stays honest.
        self._deferred: List = []  # [(dev_toks (B,1), ((slot, _Work), ...))]
        self._dev_toks = None
        self._fast_sig = None
        self._queue: collections.deque = collections.deque()
        self._slots: List[Optional[_Work]] = [None] * s.slots
        self._completed: collections.deque = collections.deque()
        self._by_id: Dict[int, Completion] = {}
        self._lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # monotonically counted totals (benchmark/ops visibility)
        self.stats = {"prefill_chunks": 0, "decode_steps": 0,
                      "generated_tokens": 0, "preemptions": 0}

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; to a CUDA device from pinned
        memory without blocking the host (the pinned buffer is held by the
        caching host allocator until the copy is done)."""
        t = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    # ----------------------------------------------------------- public API
    def submit(self, req: Request) -> int:
        """Enqueue a request; returns its request_id. Non-blocking."""
        with self._lock:
            self._queue.append(_Work(req, time.monotonic()))
        return req.request_id

    def poll(self) -> List[Completion]:
        """Drain and return completions finished since the last poll."""
        with self._lock:
            out = list(self._completed)
            self._completed.clear()
        return out

    def result(self, request_id: int) -> Optional[Completion]:
        """Completion for `request_id` if finished (kept until queried once
        via poll() too — this is a lookup, not a drain)."""
        with self._lock:
            return self._by_id.get(request_id)

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(w is not None for w in self._slots)

    def run_until_drained(self, timeout_s: float = 600.0) -> List[Completion]:
        """Drive (or wait for) the scheduler until queue + slots are empty.
        Returns the completions that finished during the drain."""
        deadline = time.monotonic() + timeout_s
        done: List[Completion] = []
        while self.has_work():
            if time.monotonic() > deadline:
                raise TimeoutError("engine did not drain within timeout")
            if self._thread is not None and self._thread.is_alive():
                time.sleep(0.001)
            else:
                self.step()
            done.extend(self.poll())
        done.extend(self.poll())
        return done

    def start(self):
        """Spawn the background scheduler thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop, name="serve-scheduler", daemon=True)
            self._thread.start()

    def stop(self):
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=30)
        self._thread = None

    @property
    def pool_hbm_bytes(self) -> int:
        return pool_bytes(self.cfg, self.scfg.num_blocks, self.scfg.block_size)

    # ------------------------------------------------------------ scheduler
    def _loop(self):
        while not self._stop_evt.is_set():
            if self.has_work():
                self.step()
            else:
                time.sleep(0.001)

    def step(self) -> bool:
        """One scheduler iteration. Returns whether any work was done."""
        with self._lock:
            self._admit()
            did = self._prefill_turn()
            did = self._decode_turn() or did
        return did

    def _eff_max_len(self, req: Request) -> int:
        return min(req.max_len or self.scfg.max_len_cap, self.scfg.max_len_cap)

    def _eff_max_new(self, req: Request) -> int:
        return req.max_new or self.scfg.default_max_new

    def _flush_deferred(self):
        """Materialise device-resident tokens into their works' `generated`
        lists (one tiny sync per deferred step, chronological order)."""
        for dev, lanes in self._deferred:
            vals = dev.cpu().numpy()
            for slot, w in lanes:
                w.generated.append(int(vals[slot, 0]))
                w.pending -= 1
        self._deferred.clear()

    def _finish(self, w: _Work, reason: str, slot: Optional[int] = None):
        if w.pending:
            self._flush_deferred()
        now = time.monotonic()
        comp = Completion(
            request_id=w.req.request_id, prompt_len=len(w.req.tokens),
            tokens=tuple(w.generated), finish_reason=reason,
            submitted_at=w.submitted_at,
            first_token_at=w.first_token_at or now, finished_at=now,
            preemptions=w.preemptions,
        )
        self.alloc.release(w.req.request_id)
        if slot is not None:
            self._slots[slot] = None
        self._completed.append(comp)
        self._by_id[comp.request_id] = comp

    def _admit(self):
        for i, slot in enumerate(self._slots):
            if slot is not None or not self._queue:
                continue
            w = self._queue.popleft()
            total = min(self._eff_max_len(w.req),
                        len(w.tokens) + self._eff_max_new(w.req) - len(w.generated))
            need = -(-total // self.scfg.block_size)
            if (len(w.tokens) > self._eff_max_len(w.req)
                    or need > self.alloc.blocks_per_table
                    or need > self.scfg.num_blocks - 1):
                # can never fit: longer than its own cap, wider than the
                # block table, or bigger than the whole pool
                self._finish(w, "error")
                continue
            self._slots[i] = w

    def _preempt(self, slot: int):
        self._flush_deferred()  # requeue recomputes from real token values
        self._fast_sig = None  # a later same-lane readmission must not reuse
        w = self._slots[slot]
        w.reset_for_requeue()
        self.alloc.release(w.req.request_id)
        self._slots[slot] = None
        self._queue.appendleft(w)
        self.stats["preemptions"] += 1

    def _victim_slot(self, requester_rid: int) -> Optional[int]:
        """Preemption victim: the block-holding slot with the YOUNGEST stable
        submission priority (request_id) — possibly the requester itself, but
        NEVER a request older than the requester (returns None instead: the
        requester waits). Both halves matter for progress: the oldest live
        request monotonically grows and finishes, and a block-less young lane
        can't evict the old one's blocks back and forth forever. Re-admission
        order must not factor in either, or two oversubscribed requests
        preempt each other alternately."""
        cand = [(w.req.request_id, i) for i, w in enumerate(self._slots)
                if w is not None and self.alloc.owned(w.req.request_id)]
        if not cand:
            return None
        rid, slot = max(cand)
        return slot if rid >= requester_rid else None

    def _prefill_turn(self) -> bool:
        """One prefill chunk for EVERY pending slot, batched into a single
        call (per-lane pos0 vector). Chunking still bounds how long a huge
        prompt can stall decode: at most `prefill_chunk` tokens per lane
        between decode batches."""
        s = self.scfg
        pending = [i for i, w in enumerate(self._slots)
                   if w is not None and w.prefilled < len(w.tokens)]
        if not pending:
            return False
        todo = []  # (slot, work, real chunk length)
        for i in pending:
            w = self._slots[i]
            c = min(s.prefill_chunk, len(w.tokens) - w.prefilled)
            try:
                self.alloc.ensure(w.req.request_id, c)
            except OutOfBlocks:
                victim = self._victim_slot(w.req.request_id)
                if victim is not None:
                    self._preempt(victim)
                # else: only OLDER requests hold blocks — wait for them
                break  # retry the rest on the next scheduler turn
            todo.append((i, w, c))
        # a lane already in `todo` may have been the preemption victim; its
        # ensured-but-unadvanced blocks were released, so drop it (ensure is
        # idempotent for the survivors — re-running next turn is safe)
        todo = [(i, w, c) for i, w, c in todo if self._slots[i] is w]
        if not todo:
            return True
        B = s.slots
        chunk = np.zeros((B, s.prefill_chunk), np.int64)
        bt = np.zeros((B, s.blocks_per_table), np.int32)
        pos0 = np.zeros((B,), np.int32)
        for i, w, c in todo:
            chunk[i, :c] = w.tokens[w.prefilled: w.prefilled + c]
            bt[i] = self.alloc.table_row(w.req.request_id)
            pos0[i] = w.prefilled
        logits, self.kv = self._prefill(
            self.params, self.kv, self._put(bt), self._put(pos0), self._put(chunk))
        done = [(i, c) for i, w, c in todo if w.prefilled + c == len(w.tokens)]
        rows = {}
        if done:  # sync only if sampling, and only the rows sampled from
            lanes, cols = zip(*done)
            got = logits[list(lanes), [c - 1 for c in cols]].float().cpu().numpy()
            rows = dict(zip(lanes, got))
        for i, w, c in todo:
            self.alloc.advance(w.req.request_id, c)
            w.prefilled += c
            self.stats["prefill_chunks"] += 1
            if w.prefilled == len(w.tokens):
                # prompt fully resident: the first output token comes straight
                # from the last chunk's logits (row of the final real token)
                self._emit_token(w, self._sample(w, rows[i]), i)
        return True

    def _decode_turn(self) -> bool:
        s = self.scfg
        active = [i for i, w in enumerate(self._slots)
                  if w is not None and w.prefilled == len(w.tokens)]
        if not active:
            return False
        # grow each lane's table by one write slot; preempt youngest on OOM
        for i in list(active):
            if self._slots[i] is None:
                continue  # already preempted as an earlier lane's victim
            w = self._slots[i]
            while True:
                try:
                    self.alloc.ensure(w.req.request_id, 1)
                    break
                except OutOfBlocks:
                    # a decoding lane holds blocks, so the victim is at
                    # worst this lane itself — never None here
                    victim = self._victim_slot(w.req.request_id)
                    if victim is None:
                        break
                    self._preempt(victim)
                    if victim == i:
                        break
            active = [j for j in active if self._slots[j] is not None]
        if not active:
            return True
        B, nb = s.slots, s.blocks_per_table
        bt = np.zeros((B, nb), np.int32)
        pos = np.zeros((B,), np.int32)
        works = tuple((i, self._slots[i]) for i in active)
        for i, w in works:
            bt[i] = self.alloc.table_row(w.req.request_id)
            pos[i] = self.alloc.length(w.req.request_id)
        sig = tuple((i, w.req.request_id) for i, w in works)
        greedy = all(w.req.temperature <= 0 for _, w in works)
        if greedy and sig == self._fast_sig and self._dev_toks is not None:
            toks = self._dev_toks  # last step's on-device argmax, no sync
        else:
            self._flush_deferred()  # host path needs real last-token values
            ht = np.zeros((B, 1), np.int64)
            for i, w in works:
                ht[i, 0] = w.generated[-1]
            toks = self._put(ht)
        logits, nxt, self.kv = self._decode(
            self.params, self.kv, self._put(bt), self._put(pos), toks)
        self.stats["decode_steps"] += 1
        for _, w in works:
            self.alloc.advance(w.req.request_id, 1)
        if greedy:
            self._dev_toks, self._fast_sig = nxt, sig
            self._deferred.append((nxt, works))
            for i, w in works:
                w.pending += 1
                self._emit_common(w, i)
        else:
            self._dev_toks = self._fast_sig = None
            logits = logits.float().cpu().numpy()
            for i, w in works:
                self._emit_token(w, self._sample(w, logits[i]), i)
        return True

    def _emit_token(self, w: _Work, tok: int, slot: int):
        w.generated.append(tok)
        self._emit_common(w, slot)

    def _emit_common(self, w: _Work, slot: int):
        if w.first_token_at is None:
            w.first_token_at = time.monotonic()
        self.stats["generated_tokens"] += 1
        if w.n_generated >= self._eff_max_new(w.req):
            self._finish(w, "max_new", slot)
        elif len(w.req.tokens) + w.n_generated >= self._eff_max_len(w.req):
            self._finish(w, "length", slot)

    def _sample(self, w: _Work, row: np.ndarray) -> int:
        """Host-side per-request sampling. Greedy is np.argmax — identical
        tie-breaking to the decode step's torch.argmax (first max)."""
        if w.req.temperature <= 0:
            return int(np.argmax(row))
        row = np.asarray(row, np.float32)
        if w.req.top_k > 0:
            kth = np.partition(row, -w.req.top_k)[-w.req.top_k]
            row = np.where(row >= kth, row, -np.inf)
        z = row / w.req.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(w.rng.choice(row.shape[0], p=p))


def generate_batch(engine: Engine, prompts: Sequence[Sequence[int]],
                   max_new: int = 16) -> List[List[int]]:
    """Submit a batch of prompts, drain, return outputs in prompt order."""
    ids = [engine.submit(Request(tokens=tuple(int(t) for t in p),
                                 max_new=max_new)) for p in prompts]
    engine.run_until_drained()
    return [list(engine.result(i).tokens) for i in ids]
