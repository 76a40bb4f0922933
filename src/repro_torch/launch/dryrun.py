"""Dry run: the memory and FLOPs of every (arch × shape) cell's step on one
card, without running it (port of repro/launch/dryrun.py: ``run_cell``,
``default_train_config``, ``default_microbatch``, ``build_parser``, ``main``).

For each cell the port's own step functions run on meta tensors
(``distributed/step.py::input_specs``: shapes and dtypes, nothing
allocated, nothing computed), under two modes stacked:

  * ``LiveBytes``, a dispatch mode that adds each new storage's bytes as
    PyTorch's CUDA caching allocator would count them (``allocator_bytes``)
    and subtracts them when the storage dies, starting from the resident
    params, optimizer state and batch: the peak is what
    ``torch.cuda.max_memory_allocated()`` would read over the step. A CUDA
    library call that takes memory no tensor holds adds it for its
    duration: cuSOLVER's copy of the SVD's input and its workspace, by the
    measured rule of ``svd_hidden_bytes`` (tools/linalg_workspace.py);
  * ``FlopCounterMode``, to which each hand kernel's shape-only launch adds
    its contractions' FLOPs (kernels/meta.py): the mode sees no hand kernel.

Both see the model's activation checkpointing as it runs (cfg.remat,
models/remat.py): ``LiveBytes`` the tensors each policy keeps for the
backward, ``FlopCounterMode`` the recompute, which lowers the useful-FLOPs
ratio. ``dry_run_grad`` reckons one forward and backward alone.

The steps driven: ``make_train_step`` at the cell's microbatch count (two
microbatches of the cell's size stand for N > 2: the peak is the same, and
the other N − 2 microbatches' FLOPs are added), the refresh apart
(``make_refresh_step``, or with the in-step refresh the train step at a
refresh step), and ``make_prefill_step`` / ``make_decode_step`` for the
serving shapes. A data-parallel world of more than one rank is not
dry-run: its sharded refresh reads assignments on the host, and a rank's
ZeRO state bytes are ``core/galore.py::galore_zero_state_bytes``.

On the pod's mesh (``--mesh``, ``run_mesh_cell``): the cell runs as rank 0
of a fake world of 256 or 512 ranks (``fake_world``) under a rule variant,
on meta DTensors of the rank's shards (``input_specs`` with rules). The
modes see the ops on the local shards (a DTensor call is handed on), and
not the fake tensors of global shapes DTensor runs to propagate shapes:
the peak is a rank's, the collectives' outputs included, the FLOPs a
rank's; ``launch/hlo_analysis.py`` records the collectives by kind.
``run_fake_rank`` runs the same step for real on a card with fake
collectives, to hold the reckoning to ``max_memory_allocated``.

Each record keeps the reference's keys where they mean the same: status
(ok / skipped with ``supports_shape``'s reason / error), memory
(peak_bytes_per_device, argument_bytes, temp_bytes), hbm_ok against the
card's memory (``torch.cuda.mem_get_info`` on a card, else ``--hbm-gib``),
raw_cost.flops, model_flops_per_device, useful_flops_ratio and, for a
GaLore train cell, refresh.peak_bytes_per_device and refresh.flops; on the
mesh also collective_schedule, costs, roofline and the refresh's
collective bytes.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --out results/dryrun_torch.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_7b --shape train_4k \
      --microbatch 256
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --rules baseline \
      --arch llama_7b
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import signal
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.base import ARCH_IDS, SHAPES, GaLoreConfig, TrainConfig, get_config
from repro_torch.distributed import world
from repro_torch.distributed.step import (
    batch_specs,
    cache_specs,
    input_specs,
    make_decode_step,
    make_prefill_step,
    make_refresh_step,
    make_train_step,
    params_specs,
)
from repro_torch.kernels import meta
from repro_torch.launch import cli, hlo_analysis
from repro_torch.launch.model_flops import model_flops, param_counts
from repro_torch.models import model as M
from repro_torch.optim.factory import external_refresh
from repro_torch.quant import QuantPolicy
from repro_torch.utils import tree_leaves, tree_map

HBM_GIB = 80.0  # the card's memory where no card answers (an H100 80GB)
CELL_TIMEOUT_S = 600  # a cell that takes longer is recorded as an error
# a mesh cell's first run plans DTensor's redistributions (on a 3-D mesh by a
# graph search, minutes a cell)
MESH_CELL_TIMEOUT_S = 1800

# PyTorch's CUDA caching allocator (c10/cuda/CUDACachingAllocator.cpp): sizes
# round up to 512 bytes; a request of 10 MiB or more takes a segment rounded
# to 2 MiB, and keeps all of it unless more than 1 MiB would be left over
_GRANULE, _SMALL, _MIN_LARGE, _ROUND_LARGE = 512, 1 << 20, 10 << 20, 2 << 20


def allocator_bytes(nbytes: int) -> int:
    """What the CUDA caching allocator counts (its allocated_bytes, which
    ``max_memory_allocated`` reads) for one allocation of `nbytes`."""
    if nbytes <= 0:
        return 0
    size = -(-nbytes // _GRANULE) * _GRANULE
    if size < _MIN_LARGE:
        return size
    segment = -(-size // _ROUND_LARGE) * _ROUND_LARGE
    return segment if segment - size <= _SMALL else size


# cusolverDnSgesvd_bufferSize(m, n) in floats, m ≥ n, as the H100 machine's
# cuSOLVER 11 returned it (tools/linalg_workspace.py): the refreshes' shapes
GESVD_LWORK = {(512, 512): 985344, (768, 768): 2034944, (1000, 520): 2695648,
               (1536, 768): 5771264, (3072, 768): 9704960, (4096, 1024): 16850176,
               (4096, 4096): 51462400, (5632, 2048): 48705280, (8192, 144): 5772768,
               (11008, 4096): 188505088}


def gesvd_lwork(m: int, n: int) -> int:
    """cuSOLVER's gesvd workspace (floats) for an m × n f32 matrix: the
    measured value, else a rule through the measurements — 3n² + 260n +
    65,792 for a square-ish matrix (exact at the three measured squares),
    and above every measured tall one 4mn + 2000n + 128m + 65,792."""
    m, n = max(m, n), min(m, n)
    if (m, n) in GESVD_LWORK:
        return GESVD_LWORK[m, n]
    if m < 1.6 * n:
        return 3 * m * n + 260 * n + 65792
    return 4 * m * n + 2000 * n + 128 * m + 65792


def svd_hidden_bytes(A) -> int:
    """What torch.linalg.svd(driver="gesvd") takes on CUDA beyond its outputs
    (measured, tools/linalg_workspace.py, exact at every probed shape): a
    column-major copy of the stacked input, which cuSOLVER overwrites, a k × k
    f32 matrix (k = min(m, n)), the workspace, k floats and 512 bytes."""
    m, n = A.shape[-2:]
    k = min(m, n)
    return (allocator_bytes(A.numel() * 4) + allocator_bytes(4 * k * k)
            + allocator_bytes(4 * gesvd_lwork(m, n)) + allocator_bytes(4 * k) + 512)


def _is_dtensor_call(types) -> bool:
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


def _local(t):
    """A DTensor's local shard (the tensor itself otherwise)."""
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


class LiveBytes(TorchDispatchMode):
    """The bytes the caching allocator would hold: every storage made under
    the mode from its creation to its death (a weak reference's callback),
    on top of the `resident` tensors' storages; ``peak`` the most at once,
    ``peak_op`` the op that reached it. Under DTensor the mode sees the ops
    on the local shards (a DTensor call is handed on), so it counts a rank's
    bytes, the collectives' outputs among them. ``accessed`` sums the bytes
    each op (views apart) reads and writes: the cell's HBM traffic."""

    def __init__(self, resident=()):
        super().__init__()
        self._seen = WeakIdKeyDictionary()
        self._made = WeakIdKeyDictionary()  # storage -> (shape, dtype) of its first tensor
        self._alias = WeakIdKeyDictionary()  # a collective's alias -> the tensor it aliases
        self.now = self.peak = self.accessed = 0
        self.peak_op = None
        for t in resident:
            self._track(_local(t))
        self._made.clear()
        self.base = self.peak = self.now

    def _track(self, t) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = allocator_bytes(st.nbytes())
        self._seen[st] = weakref.ref(st, functools.partial(self._free, n))
        self._made[st] = (tuple(t.shape), t.dtype)
        self.now += n

    def held(self) -> list:
        """(shape, dtype) of each storage made under the mode and alive now:
        the tensor that made it (a view may hold it since)."""
        return list(self._made.values())

    def _free(self, n, _ref) -> None:
        self.now -= n

    def _mark(self, name: str, extra: int = 0) -> None:
        if self.now + extra > self.peak:
            self.peak, self.peak_op = self.now + extra, name

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_call(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if hlo_analysis.shadow_op(out):
            return out
        if hlo_analysis.collective_alias(func):
            # on a device the output is the input's buffer: it is not counted
            # again, and it keeps the input's bytes alive while it lives
            src = next(a for a in _pytree_leaves(args) if isinstance(a, torch.Tensor))
            for t in _pytree_leaves(out):
                if isinstance(t, torch.Tensor) and t.untyped_storage() is not src.untyped_storage():
                    self._alias[t.untyped_storage()] = src
            return out
        name = func.overloadpacket.__name__
        if not getattr(func, "is_view", False):
            self.accessed += sum(t.numel() * t.element_size()
                                 for t in _pytree_leaves((args, kwargs, out))
                                 if isinstance(t, torch.Tensor))
        for t in _pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        # the SVD's hidden bytes are held while it runs; QR's and eigh's
        # (under 7 MB at every probed shape) are not counted
        self._mark(name, svd_hidden_bytes(args[0]) if name == "_linalg_svd" else 0)
        return out


class _LocalFlopMode(_FlopCounterMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_call(types):
            return NotImplemented
        if hlo_analysis.shadow_op(args):  # DTensor's shape propagation
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class LocalFlops(FlopCounterMode):
    """FlopCounterMode that, under DTensor, counts the ops on the local
    shards (a rank's FLOPs); on plain tensors it is FlopCounterMode."""

    def __enter__(self):
        super().__enter__()
        self.mode.__exit__(None, None, None)
        self.mode = _LocalFlopMode(self)
        self.mode.__enter__()
        return self


class _Timeout(Exception):
    pass


def _measure(fn, resident, mesh=None):
    """fn() under LiveBytes(resident), LocalFlops and, with a `mesh`, a
    CollectiveRecorder: (its result, {"peak", "argument", "flops",
    "peak_op", "kernels", "accessed"[, "collectives"]})."""
    meta.reset()
    recorder = hlo_analysis.CollectiveRecorder(mesh) if mesh is not None else None
    with contextlib.ExitStack() as stack:
        flops = stack.enter_context(LocalFlops(display=False))
        live = stack.enter_context(LiveBytes(resident))
        if recorder is not None:
            stack.enter_context(recorder)
        out = fn()
    rec = {"peak": live.peak, "argument": live.base, "peak_op": live.peak_op,
           "flops": int(flops.get_total_flops()) + meta.kernel_flops(),
           "kernels": {k: v for k, v in meta.launch_counts().items() if v},
           "accessed": live.accessed}
    if recorder is not None:
        rec["collectives"] = recorder
    return out, rec


def _tensors(*trees) -> list:
    return [t for t in tree_leaves(list(trees)) if isinstance(t, torch.Tensor)]


def dry_run_step(cfg, tc: TrainConfig | None, rows: int, seq_len: int, kind: str) -> dict:
    """One step of `kind` ("train", "prefill" or "decode") at `rows` × `seq_len`
    on meta tensors: {"peak_bytes", "argument_bytes", "temp_bytes", "flops",
    "peak_op", "kernels" (shape-only launches by wrapper), and for a GaLore
    train step "refresh": the same of the refresh step}. The train step's
    record is its first step without a refresh; "peak_bytes" and "peak_op"
    of the whole are the larger peak's ("step_peak_bytes" the step's). A
    GaLore config with the in-step refresh takes its refresh inside train
    step 0, which is recorded as "refresh"."""
    if world.n_dp() > 1:
        raise ValueError("the dry run is one process on one card; a world's sharded refresh "
                         "reads its assignment on the host (see galore_zero_state_bytes)")
    params = params_specs(cfg)
    cell = dataclasses.replace(SHAPES["train_4k"], global_batch=rows, seq_len=seq_len, kind=kind)
    if kind == "prefill":
        cache, batch = cache_specs(cfg, cell), batch_specs(cfg, cell)
        step = make_prefill_step(cfg)
        _, rec = _measure(lambda: step(params, cache, batch), _tensors(params, cache, batch))
        return _record(rec)
    if kind == "decode":
        cache, batch = cache_specs(cfg, cell), batch_specs(cfg, cell)
        step = make_decode_step(cfg)
        _, rec = _measure(lambda: step(params, cache, batch["tokens"], seq_len - 1),
                          _tensors(params, cache, batch))
        return _record(rec)
    nm = tc.microbatch if tc.microbatch and tc.microbatch > 1 else 1
    if rows % nm:
        raise ValueError(f"{rows} rows do not split into {nm} microbatches")
    run_nm = min(nm, 2)  # two microbatches peak as N do
    tc_run = dataclasses.replace(tc, microbatch=run_nm if nm > 1 else tc.microbatch)
    # the whole batch stays resident; the run takes its first microbatches
    batch = {k: v.narrow(1 if k == "positions" else 0, 0, rows // nm * run_nm)
             for k, v in batch_specs(cfg, cell).items()}
    train_step, opt = make_train_step(cfg, tc_run)
    state = opt.init(params)
    out = {}
    if tc.galore is not None:
        if external_refresh(tc):
            refresh = make_refresh_step(cfg, tc_run)
            state, out["refresh"] = _measure(lambda: refresh(params, state, batch, None),
                                             _tensors(params, state, batch))
        else:  # step 0 of the in-step refresh
            (params, state, _), out["refresh"] = _measure(
                lambda: train_step(params, state, batch), _tensors(params, state, batch))
    _, step_rec = _measure(lambda: train_step(params, state, batch),
                           _tensors(params, state, batch))
    if nm > 2:  # the N − 2 microbatches not run: their forward and backward
        step_rec["flops"] += (nm - 2) * _fwd_bwd(cfg, params, world.microbatch(batch, 0, run_nm),
                                                 tc.z_loss)["flops"]
    rec = _record(step_rec)
    if "refresh" in out:
        rec["refresh"] = _record(out["refresh"])
        rec["step_peak_bytes"] = rec["peak_bytes"]
        if rec["refresh"]["peak_bytes"] > rec["peak_bytes"]:
            rec["peak_bytes"], rec["peak_op"] = (rec["refresh"]["peak_bytes"],
                                                 rec["refresh"]["peak_op"])
    return rec


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a fake world of `n` ranks (torch's "fake"
    process group: collectives return their outputs unfilled, nothing is
    sent), destroyed on leaving, so the process is left as it was."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists already: the fake world needs its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dry_run_sharded(cfg, tc: TrainConfig | None, shape_name: str, rules) -> dict:
    """One step of a cell as rank 0 of a mesh (`rules` over a DeviceMesh of a
    world, real or fake), on meta DTensors of the rank's shards
    (``input_specs`` with rules): ``_record``'s fields of the rank, with
    "accessed" (its HBM bytes) and "collectives" (a CollectiveRecorder),
    and for a GaLore train cell "refresh", the same of the refresh step.
    Every microbatch runs; the refresh is the external one."""
    cell = SHAPES[shape_name]
    mesh = rules.mesh
    specs = input_specs(cfg, shape_name, tc, rules)
    params = specs["params"]

    def record(rec):
        return dict(_record(rec), accessed=rec["accessed"], collectives=rec["collectives"])

    if cell.kind == "prefill":
        step = make_prefill_step(cfg, rules)
        _, rec = _measure(lambda: step(params, specs["cache"], specs["batch"]),
                          _tensors(params, specs["cache"], specs["batch"]), mesh)
        return record(rec)
    if cell.kind == "decode":
        step = make_decode_step(cfg, rules)
        _, rec = _measure(lambda: step(params, specs["cache"], specs["tokens"], specs["pos"]),
                          _tensors(params, specs["cache"], specs["tokens"]), mesh)
        return record(rec)
    train_step, _ = make_train_step(cfg, tc, rules)
    state, batch, out = specs["opt_state"], specs["batch"], {}
    if tc.galore is not None:
        if not external_refresh(tc):
            raise ValueError("the sharded dry run takes the external refresh")
        refresh = make_refresh_step(cfg, tc, rules)
        state, rrec = _measure(lambda: refresh(params, state, batch, None),
                               _tensors(params, state, batch), mesh)
        out["refresh"] = record(rrec)
    _, srec = _measure(lambda: train_step(params, state, batch), _tensors(params, state, batch),
                       mesh)
    rec = record(srec)
    rec.update(out)
    return rec


def materializer(device, seed: int = 0):
    """make(x, high=2): a meta (D)Tensor of a spec tree (``input_specs``) as
    a tensor on `device` holding this rank's shard, drawn from `seed`: a
    floating one small normal draws (requiring grad where the spec does),
    an integer one draws below `high`. Anything not on the meta device is
    returned as it is."""
    from torch.distributed.tensor import DTensor

    gen = torch.Generator(device=device).manual_seed(seed)

    def make(x, high=2):
        if not isinstance(x, torch.Tensor) or not x.is_meta:
            return x
        local = x.to_local() if isinstance(x, DTensor) else x
        if local.is_floating_point():
            t = (torch.randn(local.shape, generator=gen, device=device) * 0.02).to(local.dtype)
        else:
            t = torch.randint(0, high, local.shape, generator=gen, device=device,
                              dtype=local.dtype)
        if isinstance(x, DTensor):
            t = DTensor.from_local(t, x.device_mesh, x.placements, run_check=False,
                                   shape=x.shape, stride=x.stride())
        return t.requires_grad_(x.requires_grad)

    return make


class ZeroedCollectives(TorchDispatchMode):
    """Zeroes, in place, the output of every collective DTensor issues under
    it (``hlo_analysis.collective_kind``): a fake world's collectives leave
    their outputs unwritten, and an index gathered from one would be any
    number."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _is_dtensor_call(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if hlo_analysis.collective_kind(func) is not None:
            for t in _pytree_leaves(out):
                if isinstance(t, torch.Tensor):
                    t.zero_()
        return out


def run_fake_rank(cfg, tc: TrainConfig, shape_name: str, rules, device="cuda",
                  seed: int = 0) -> dict:
    """One train step of a cell, for real, as rank 0 of the fake world
    `rules` lives on: ``input_specs`` made tensors on `device` (this rank's
    shards, drawn from `seed`), then ``make_train_step``'s step. The
    collectives are fake (their outputs zeroed): the values mean nothing,
    the time is compute only. Returns {"peak_bytes": on a card, the most
    the caching allocator held above what it held before the inputs were
    made (None elsewhere), "collectives": a CollectiveRecorder of the step,
    "seconds"}."""
    cuda = torch.device(device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    specs = input_specs(cfg, shape_name, tc, rules)
    make = materializer(device, seed)
    sync()
    before = torch.cuda.memory_allocated(device) if cuda else 0
    params = tree_map(make, specs["params"])
    state = tree_map(make, specs["opt_state"])
    batch = {k: make(v, cfg.vocab_size) for k, v in specs["batch"].items()}
    batch["loss_mask"] = torch.ones_like(batch["loss_mask"])  # every token counts
    del specs
    step, _ = make_train_step(cfg, tc, rules)
    recorder = hlo_analysis.CollectiveRecorder(rules.mesh)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with recorder, ZeroedCollectives():
        step(params, state, batch)
    sync()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - before if cuda else None
    return {"peak_bytes": peak, "collectives": recorder, "seconds": seconds}


def dry_run_grad(cfg, rows: int, seq_len: int) -> dict:
    """loss_fn's forward and the backward to every leaf (no optimizer) at
    `rows` × `seq_len` on meta tensors, a train cell's batch: _fwd_bwd's
    record."""
    cell = dataclasses.replace(SHAPES["train_4k"], global_batch=rows, seq_len=seq_len,
                               kind="train")
    return _fwd_bwd(cfg, params_specs(cfg), batch_specs(cfg, cell))


def _fwd_bwd(cfg, params, batch, z_loss: float = 0.0) -> dict:
    """{"peak_bytes", "argument_bytes" (the params and batch), "kept_bytes"
    (what the forward leaves for the backward: the live bytes above those
    once the loss is made, which cfg.remat sets), "flops" (the recompute
    included)} of loss_fn's forward and backward to every leaf."""
    with FlopCounterMode(display=False) as flops, LiveBytes(_tensors(params, batch)) as live:
        loss, _ = M.loss_fn(cfg, params, batch, z_loss=z_loss)
        kept = live.now - live.base
        torch.autograd.grad(loss, tree_leaves(params))
    return {"peak_bytes": live.peak, "argument_bytes": live.base, "kept_bytes": kept,
            "flops": int(flops.get_total_flops())}


def _record(rec) -> dict:
    return {"peak_bytes": rec["peak"], "argument_bytes": rec["argument"],
            "temp_bytes": rec["peak"] - rec["argument"], "flops": rec["flops"],
            "peak_op": rec["peak_op"], "kernels": rec["kernels"]}


def default_microbatch(cfg) -> int:
    """Gradient-accumulation factor for train_4k, by model scale (the
    reference's: 8 above 90e9 parameters, 2 above 15e9, else 1)."""
    total = param_counts(cfg)["total"]
    if total > 90e9:
        return 8
    if total > 15e9:
        return 2
    return 1


def default_train_config(cfg, optimizer: str = "adamw", galore: bool = True,
                         microbatch: int | None = None, rank_frac: float = 0.0,
                         adaptive_t: bool = False, stagger: bool = False,
                         quant_moments: str = "fp32", quant_proj: str = "fp32") -> TrainConfig:
    """The reference's paper-faithful defaults: GaLore rank ≈ d_model/4
    (Table 2), T = 200, α = 0.25, the Newton–Schulz projector, the external
    refresh, clip 1.0, no weight decay."""
    rank = max(128, (cfg.d_model // 4) // 128 * 128)
    g = GaLoreConfig(rank=rank, update_freq=200, scale=0.25, projector="newton_schulz",
                     rank_frac=rank_frac, adaptive_t=adaptive_t, refresh_stagger=stagger,
                     quant=QuantPolicy(moments=quant_moments, projectors=quant_proj)
                     ) if galore else None
    mb = default_microbatch(cfg) if microbatch is None else microbatch
    return TrainConfig(optimizer=optimizer, galore=g, grad_clip=1.0, weight_decay=0.0,
                       microbatch=mb, galore_external_refresh=True)


def card_bytes(hbm_gib: float = HBM_GIB) -> int:
    """The card's memory: ``torch.cuda.mem_get_info`` where a card answers,
    else `hbm_gib` GiB."""
    if torch.cuda.is_available():
        return torch.cuda.mem_get_info()[1]
    return int(hbm_gib * 2**30)


def run_cell(arch: str, shape_name: str, *, optimizer: str = "adamw", galore: bool = True,
             microbatch: int | None = None, rank_frac: float = 0.0, adaptive_t: bool = False,
             stagger: bool = False, quant_moments: str = "fp32", quant_proj: str = "fp32",
             overrides: dict | None = None, galore_dp: bool = False,
             hbm_gib: float = HBM_GIB, mesh: str | None = None,
             rules_name: str = "baseline") -> dict:
    """The dry run of one (arch × shape) cell on one card; `overrides` are
    ModelConfig fields, `galore_dp` the compressed step (no accumulation).
    With `mesh` ("single": the 16 × 16 pod, "multi": 2 × 16 × 16) the cell
    runs as rank 0 of a fake world of 256 or 512 ranks under the rule
    variant `rules_name` (``run_mesh_cell``)."""
    if mesh is not None:
        return run_mesh_cell(arch, shape_name, multi_pod=mesh == "multi", rules_name=rules_name,
                             optimizer=optimizer, galore=galore, microbatch=microbatch,
                             rank_frac=rank_frac, adaptive_t=adaptive_t, stagger=stagger,
                             quant_moments=quant_moments, quant_proj=quant_proj,
                             overrides=overrides, galore_dp=galore_dp, hbm_gib=hbm_gib)
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape_name]
    ok, reason = cfg.supports_shape(shape_name)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": "1 card", "rules": "baseline",
                 "optimizer": optimizer if cell.kind == "train" else None}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    tc = None
    if cell.kind == "train":
        tc = default_train_config(cfg, optimizer, galore, microbatch, rank_frac, adaptive_t,
                                  stagger, quant_moments, quant_proj)
        if galore_dp:
            tc = dataclasses.replace(tc, galore_dp_compress=True, microbatch=0)
        rec["microbatch"] = tc.microbatch
    t0 = time.time()
    res = dry_run_step(cfg, tc, cell.global_batch, cell.seq_len, cell.kind)
    mf = model_flops(cfg, shape_name)
    rec.update(
        status="ok", dryrun_s=round(time.time() - t0, 1),
        memory={"argument_bytes": res["argument_bytes"], "temp_bytes": res["temp_bytes"],
                "peak_bytes_per_device": res["peak_bytes"]},
        hbm_ok=res["peak_bytes"] < card_bytes(hbm_gib),
        raw_cost={"flops": res["flops"]}, peak_op=res["peak_op"], kernels=res["kernels"],
        model_flops_global=mf, model_flops_per_device=mf,
        useful_flops_ratio=mf / res["flops"] if res["flops"] else None)
    if "refresh" in res:
        rec["refresh"] = {"peak_bytes_per_device": res["refresh"]["peak_bytes"],
                          "flops": res["refresh"]["flops"]}
    return rec


def run_mesh_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                  rules_name: str = "baseline", optimizer: str = "adamw", galore: bool = True,
                  microbatch: int | None = None, rank_frac: float = 0.0,
                  adaptive_t: bool = False, stagger: bool = False, quant_moments: str = "fp32",
                  quant_proj: str = "fp32", overrides: dict | None = None,
                  galore_dp: bool = False, hbm_gib: float = HBM_GIB,
                  device_type: str = "cuda") -> dict:
    """The sharded dry run of one cell: rank 0 of a fake world of the pod's
    256 (512 with `multi_pod`) ranks, on the meta device. The record keeps
    the reference's fields: memory (peak_bytes_per_device, from LiveBytes on
    the local shards and the collectives' outputs), hbm_ok against the
    card, collective_schedule, costs and roofline (hlo_analysis.py),
    model_flops_per_device (model_flops / ranks), useful_flops_ratio, and
    for a GaLore train cell the refresh's peak, FLOPs and collective bytes
    and its compute amortised over T. The mesh is a CUDA one (on a host
    without a card too: nothing runs on it), so DTensor picks the
    collectives it picks over NCCL (an all-to-all where gloo would gather)."""
    from repro_torch.launch.mesh import make_production_mesh, rules_variant

    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape_name]
    ok, reason = cfg.supports_shape(shape_name)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16",
                 "rules": rules_name, "optimizer": optimizer if cell.kind == "train" else None}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    tc = None
    if cell.kind == "train":
        tc = default_train_config(cfg, optimizer, galore, microbatch, rank_frac, adaptive_t,
                                  stagger, quant_moments, quant_proj)
        if galore_dp:
            tc = dataclasses.replace(tc, galore_dp_compress=True, microbatch=0)
        rec["microbatch"] = tc.microbatch
    n = 512 if multi_pod else 256
    t0 = time.time()
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
        rules = rules_variant(mesh, rules_name, long_context=shape_name == "long_500k")
        res = dry_run_sharded(cfg, tc, shape_name, rules)
        costs = hlo_analysis.measure(res["flops"], res["accessed"], res["collectives"])
        refresh_coll = (res["refresh"]["collectives"].stats() if "refresh" in res else None)
    mf = model_flops(cfg, shape_name)
    rec.update(
        status="ok", dryrun_s=round(time.time() - t0, 1),
        memory={"argument_bytes": res["argument_bytes"], "temp_bytes": res["temp_bytes"],
                "peak_bytes_per_device": res["peak_bytes"]},
        hbm_ok=res["peak_bytes"] < card_bytes(hbm_gib),
        collective_schedule=res["collectives"].stats().as_dict(),
        raw_cost={"flops": res["flops"], "bytes": res["accessed"]}, peak_op=res["peak_op"],
        costs=costs.as_dict(), roofline=hlo_analysis.roofline_terms(costs),
        model_flops_global=mf, model_flops_per_device=mf / n,
        useful_flops_ratio=mf / n / res["flops"] if res["flops"] else None)
    if "refresh" in res:
        r = res["refresh"]
        rec["refresh"] = {
            "peak_bytes_per_device": r["peak_bytes"], "flops": r["flops"],
            "collective_bytes": refresh_coll.total_bytes,
            "collective_schedule": refresh_coll.as_dict(),
            "amortized_compute_s": r["flops"] / hlo_analysis.HW["peak_flops_bf16"]
            / tc.galore.update_freq}
    return rec


def build_parser():
    """Argparse parser of the dry run (the reference's flags; without --mesh
    the cells run on one card; --skip-scaling has nothing to skip)."""
    from repro_torch.launch.mesh import VARIANTS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description="memory/FLOPs dry run over the arch × shape grid, "
                                             "on the meta device, for one card or as rank 0 "
                                             "of a pod's mesh")
    ap.add_argument("--out", default=None,
                    help="default results/dryrun_torch.json, with --mesh "
                         "results/dryrun_torch_mesh.json")
    ap.add_argument("--arch", nargs="*", default=None)
    ap.add_argument("--shape", nargs="*", default=None)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--no-galore", action="store_true")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="train cells' accumulation factor (default: the reference's by "
                         "model scale; the global batch: one sequence a microbatch)")
    cli.add_galore_subspace_flags(ap)
    cli.add_quant_flags(ap)
    ap.add_argument("--hbm-gib", type=float, default=HBM_GIB,
                    help="the card's memory where no card answers")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default=None,
                    help="run each cell as rank 0 of a fake world: the 16 × 16 pod (single), "
                         "2 × 16 × 16 (multi) or both")
    ap.add_argument("--rules", choices=VARIANTS, default=None,
                    help="the sharding rule variant (with --mesh; default baseline)")
    ap.add_argument("--skip-scaling", nargs="?", const=True, default=None,
                    help=argparse.SUPPRESS)  # refused
    return ap


def cell_key(arch: str, shape: str, microbatch, mesh: str | None = None,
             rules: str = "baseline") -> str:
    mb = f"mb {'default' if microbatch is None else microbatch}"
    if mesh is None:
        return f"{arch}|{shape}|1 card|{mb}"
    return f"{arch}|{shape}|{'2x16x16' if mesh == 'multi' else '16x16'}|{rules}|{mb}"


def mesh_label(mesh: str | None) -> str:
    return {None: "1 card", "single": "16x16", "multi": "2x16x16"}[mesh]


def _on_alarm(signum, frame):
    raise _Timeout()


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.skip_scaling is not None:
        ap.error("--skip-scaling has nothing to skip: the port counts every layer at full "
                 "depth (the reference lowers reduced depths because XLA counts a scan body "
                 "once)")
    if args.rules is not None and args.mesh is None:
        ap.error("--rules places a cell on a mesh: give --mesh single|multi|both")
    rules_name = args.rules or "baseline"
    meshes = {None: [None], "single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    if args.out is None:
        args.out = "results/dryrun_torch.json" if args.mesh is None else \
            "results/dryrun_torch_mesh.json"
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            results = json.load(f)
    old = signal.signal(signal.SIGALRM, _on_alarm)
    try:
        for arch, shape, mesh in ((a, s, m) for a in args.arch or ARCH_IDS
                                  for s in args.shape or list(SHAPES) for m in meshes):
            key = cell_key(arch, shape, args.microbatch, mesh, rules_name)
            if key in results and results[key].get("status") in ("ok", "skipped"):
                print(f"[dryrun] cached {key}")
                continue
            print(f"[dryrun] {key} ...", flush=True)
            t0 = time.time()
            limit = CELL_TIMEOUT_S if mesh is None else MESH_CELL_TIMEOUT_S
            signal.setitimer(signal.ITIMER_REAL, limit)
            try:
                rec = run_cell(arch, shape, optimizer=args.optimizer,
                               galore=not args.no_galore, microbatch=args.microbatch,
                               rank_frac=args.galore_rank_frac,
                               adaptive_t=args.galore_adaptive_t, stagger=args.galore_stagger,
                               quant_moments=args.quant_moments, quant_proj=args.quant_proj,
                               hbm_gib=args.hbm_gib, mesh=mesh, rules_name=rules_name)
            except _Timeout:
                rec = {"arch": arch, "shape": shape, "mesh": mesh_label(mesh), "status": "error",
                       "error": f"over the cell timeout ({limit} s)",
                       "dryrun_s": round(time.time() - t0, 1)}
            except Exception as e:  # noqa: BLE001 — record the failure, keep going
                rec = {"arch": arch, "shape": shape, "mesh": mesh_label(mesh), "status": "error",
                       "error": repr(e), "trace": traceback.format_exc()[-2000:],
                       "dryrun_s": round(time.time() - t0, 1)}
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
            results[key] = rec
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
            extra = ""
            if rec["status"] == "ok":
                extra = (f" peak={rec['memory']['peak_bytes_per_device'] / 2**30:.2f} GiB "
                         f"hbm_ok={rec['hbm_ok']} flops={rec['raw_cost']['flops']:.3e} "
                         f"useful={rec['useful_flops_ratio']:.3f} ({rec['dryrun_s']} s)")
            elif rec["status"] == "error":
                extra = f" {rec['error'][:200]}"
            print(f"[dryrun] {key}: {rec['status']}{extra}", flush=True)
    finally:
        signal.signal(signal.SIGALRM, old)
    counts = {s: sum(r.get("status") == s for r in results.values())
              for s in ("ok", "skipped", "error")}
    print(f"[dryrun] done: {counts['ok']} ok, {counts['skipped']} skipped, {counts['error']} "
          f"errors -> {args.out}")


if __name__ == "__main__":
    main()
