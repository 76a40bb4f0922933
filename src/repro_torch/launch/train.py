"""Training launcher (port of the one-device repro/launch/train.py).

Takes GaLore (or full-rank) steps of AdamW, Adam, 8-bit Adam, Adafactor or
SGD with momentum on a synthetic C4-like stream and logs
``[train] step N loss …`` (and the MoE load-balancing loss, ``aux_loss``, for a
model with experts). ``--arch`` takes every architecture the port registers
(``configs/base.py::ARCH_IDS`` and the paper's LLaMAs), smoke-sized unless
``--full``; ``--layers N`` cuts the depth. Batches are text only, as the
reference's launcher makes them, so the audio family (``whisper_small``),
whose batches carry "enc_frames", trains through ``train_loop(data=…)``;
without such a source it raises KeyError before step 0. Runs on ``cuda``
unless ``--device`` says otherwise. Ported with the loop:
  * checkpoints every ``--ckpt-every`` steps (async, atomic; crc-checked and
    carrying the guard's state when guarded; ``--ckpt-quantize`` for the
    params' file codec) with the pipeline's position in META, and
    auto-resume from the newest checkpoint (the newest VALID one when
    guarded) in ``--ckpt-dir``;
  * preemption: touch <ckpt_dir>/PREEMPT to save (blocking) and return;
  * the anomaly guard (``--anomaly-guard``): a non-finite or spiking step is
    a no-op, and with GaLore a non-finite gradient voids the refresh, a
    failed SVD falls back to the randomized projector and the async swap
    rejects a poisoned P_next (guard_refresh);
  * fault injection (``--inject-fault``) and escalation (``--recover-*``):
    K consecutive skips roll back to the newest valid checkpoint (or to the
    initial state), a bounded number of times, then TrainingFailure; with
    ``--recover-resync`` and an external or async refresh, one force-all
    refresh follows the rollback;
  * the straggler watchdog line (a step over twice the EMA step time);
  * the refresh lifecycle: per-leaf ranks (``--galore-rank-frac``), stagger
    (``--galore-stagger``, by measured gradient norm with
    ``--galore-stagger-importance``), adaptive T (``--galore-adaptive-t``),
    the external refresh (``--galore-external-refresh``,
    ``make_refresh_caller``) and the async double buffer
    (``--galore-refresh-async``, ``AsyncRefreshDriver``, with
    ``--galore-reproject-moments``); a checkpoint taken with an async
    refresh in flight carries its ``pending`` group, and a resume swaps it
    in where the interrupted run would have;
  * data parallel: started by ``python -m torch.distributed.run
    --nproc-per-node N -m repro_torch.launch.train …``, every rank joins the
    world (distributed/world.py; ``--dist-backend gloo`` lets two ranks share
    one card), reads the same global batch and trains on its rows; rank 0
    alone prints the ``[train]`` lines and writes checkpoints. With it
    GaLore-DP (``--galore-dp-compress``), the sharded refresh
    (``--galore-refresh-shard``, bin-packed on measured SVD times with
    ``--galore-calibrate-costs``, re-measured every N async dispatches with
    ``--galore-recalibrate-costs N``), GaLore-ZeRO (``--galore-zero 1|2``:
    checkpoints hold the full layout and restore onto any number of ranks)
    and ``--galore-tp-aware-side``.

CLI:  PYTHONPATH=src python -m repro_torch.launch.train --arch llama_60m --steps 20 \\
          --galore-rank 16 --galore-t 10 --galore-fused --ckpt-dir /path/to/ckpt
      (add --quant-moments int8 --quant-proj int4 for 8-bit GaLore, and
      --galore-fused-apply to fold the weight update into the kernel;
      --optimizer adam8bit without --galore-rank is the 8-bit Adam baseline;
      --optimizer adafactor or sgd, with --galore-rank or without, the
      paper's other optimizers, GaLore's composable path around them;
      --anomaly-guard --inject-fault nan_grad@5*3 --ckpt-every 4 drives a
      rollback; --galore-stagger --galore-refresh-async the async refresh)
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import math
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config
from repro_torch.core.galore import (
    galore_zero_state_bytes,
    init_pending_state,
    refresh_projectors_pending,
)
from repro_torch.core.subspace import (
    SubspaceManager,
    calibrate_unit_costs,
    importance_order_from_grads,
    sum_units,
)
from repro_torch.data.pipeline import DataConfig, SyntheticC4
from repro_torch.distributed import world
from repro_torch.distributed.state_sharding import ZeroLayout, galore_state_tensor_bytes
from repro_torch.distributed.step import (
    make_refresh_grads,
    make_refresh_step,
    make_swap_step,
    make_train_step,
    shard_units,
)
from repro_torch.kernels import ops
from repro_torch.launch import cli
from repro_torch.models import model as M
from repro_torch.optim.factory import (
    effective_galore_config,
    external_refresh,
    galore_state_index,
)
from repro_torch.robust import (
    TRACED_KINDS,
    FaultInjector,
    RecoveryController,
    identity_fault,
    init_guard_state,
    parse_fault,
)
from repro_torch.utils import resolve_device, tree_leaves, tree_map, tree_unflatten_like

# the reference's /tmp/repro_ckpt, under the process's temporary directory
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclasses.dataclass
class RunConfig:
    arch: str = "llama_60m"
    smoke: bool = True
    steps: int = 200
    batch_per_host: int = 8
    seq_len: int = 256
    ckpt_dir: str = DEFAULT_CKPT_DIR  # a run resumes from what it finds here
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_quantize: str | None = None  # file codec of large params leaves: None | int8 | int4
    device: str | None = None  # None -> cuda, and an error when there is none
    report: str | None = None  # write this rank's run report to <report>.rank<k>.json


def with_measured_importance(cfg, tc: TrainConfig, params, batch) -> TrainConfig:
    """tc with GaLoreConfig.importance_order stamped from one measured
    gradient: the ≥ 2-D leaves by the Frobenius norm of `batch`'s gradient,
    descending. The order is static config, so every plan derivation (the
    optimizer's init and update, the external refresh) agrees on it."""
    loss, _ = M.loss_fn(cfg, params, batch, z_loss=tc.z_loss)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    order = importance_order_from_grads(tree_unflatten_like(params, list(grads)))
    return dataclasses.replace(tc, galore=dataclasses.replace(tc.galore, importance_order=order))


def log(*args, **kw):
    """print, on rank 0 of a world only."""
    if world.rank() == 0:
        print(*args, **kw)


def with_calibrated_costs(cfg, tc: TrainConfig, params) -> TrainConfig:
    """tc with GaLoreConfig.unit_costs stamped from one timed projector
    compute per galore leaf shape on the params' device
    (core/subspace.py::calibrate_unit_costs); in a world, rank 0's times, so
    every rank packs the sharded refresh alike."""
    costs = calibrate_unit_costs(params, effective_galore_config(tc), param_axes=M.param_axes(cfg))
    secs = world.broadcast(torch.tensor([v for _, v in costs], dtype=torch.float64), 0)
    costs = tuple((k, float(v)) for (k, _), v in zip(costs, secs.tolist()))
    return dataclasses.replace(tc, galore=dataclasses.replace(tc.galore, unit_costs=costs))


def galore_due_offsets(params, tc: TrainConfig) -> set:
    """The due phases of a staggered schedule (refresh_offset % T over the
    galore leaves): make_due's, so the refresh caller and the async driver
    can never disagree on dueness."""
    gcfg = effective_galore_config(tc)
    T = gcfg.update_freq
    return {pl.refresh_offset % T for pl in tree_leaves(SubspaceManager(gcfg).plans(params))
            if pl.galore}


def make_due(tc: TrainConfig, params):
    """due(galore_state, step) -> (due, step_arg): whether any leaf is due
    at `step`, decided on the host, and the step its refresh takes. A
    staggered schedule is due at the phases its offsets hold (and step 0),
    adaptive T where some leaf's `next` has come (the host-int schedule; the
    reference runs a refresh that changes nothing at the other steps), both
    refreshing only the due leaves; the plain schedule at steps 0, T, 2T, …,
    every projector (step_arg None). The port passes the real step where the
    reference folds it into a window phase to bound its retraces; dueness is
    the same."""
    gcfg = effective_galore_config(tc)
    T = gcfg.update_freq
    offsets = galore_due_offsets(params, tc)
    mgr = SubspaceManager(gcfg)
    plans = mgr.plans(params)

    def due(galore_state, step):
        if gcfg.adaptive_t:
            return any(mgr.due_mask(plans, galore_state["schedule"], step)), step
        if gcfg.refresh_stagger:
            return step == 0 or step % T in offsets, step
        return step % T == 0, None

    return due


def make_refresh_caller(cfg, tc: TrainConfig, params):
    """The external refresh's driver: maybe_refresh(params, opt_state, batch,
    step) -> opt_state, run before the train step: where `make_due` says a
    leaf is due, a refresh from its own gradient of the step's batch
    (``maybe_refresh.refresh_step`` is that refresh)."""
    idx = galore_state_index(tc)
    refresh = make_refresh_step(cfg, tc)
    due = make_due(tc, params)

    def maybe_refresh(params, opt_state, batch, step):
        is_due, arg = due(opt_state[idx], step)
        return refresh(params, opt_state, batch, arg) if is_due else opt_state

    maybe_refresh.refresh_step = refresh
    return maybe_refresh


class AsyncRefreshDriver:
    """The double-buffered refresh (tc.galore_refresh_async).

    At a due step t the refresh runs on the previous step's batch (the stale
    gradient, GaLore 2's) while the train step at t runs on P_active; its
    result, the pending buffer {"proj", "flag"[, "schedule"]}, swaps in at
    the next step boundary, where the reference swaps. Step 0 refreshes
    synchronously (the projectors are zeros and there is no earlier batch).

    The reference overlaps through XLA's asynchronous dispatch. Here
    ``torch.linalg.svd`` on a CUDA tensor blocks its host thread until it
    is done (it reads its ``info`` on the host), so the refresh's gradient
    is enqueued on a CUDA stream of its own, and its SVDs run on a host
    thread on that stream. The main stream waits, on the device, for that
    gradient before the train step, which updates the params in place, so
    the refresh reads the params as they were at dispatch; the SVDs overlap
    the train step. Every tensor of the pending buffer is recorded on the
    main stream at the swap (``record_stream``), so the caching allocator
    never hands its memory back while the main stream reads it. A failure of
    the thread re-raises at the swap; nothing catches it.

    ``pending`` (which waits for an in-flight refresh) is what a checkpoint
    saves while ``in_flight``; ``restore_pending`` re-arms it after a resume
    and ``prime_stale`` gives the first resumed step its stale batch, so the
    resumed run swaps what the interrupted one would have. ``history`` holds,
    per refresh dispatched, its step, SVD units (stacked elements
    recomputed), host seconds to enqueue its gradient, seconds the thread
    took, and seconds the main thread waited for it at the swap.

    In a world no collective runs on the thread, so each rank's collectives
    keep one order: the gradient's mean and, under ZeRO, the gather of the
    active projectors run at the dispatch, and under the sharded refresh the
    thread computes this rank's SVD units only, summed over the world at
    the swap, where the store and schedule follow. With
    tc.galore_recalibrate_every = N the SVD unit costs are measured again
    every N dispatches and the refresh rebuilt on them (``recalibrations``
    counts the rebuilds)."""

    def __init__(self, cfg, tc: TrainConfig, params):
        self._cfg, self._params = cfg, params
        self.recal_every = int(tc.galore_recalibrate_every or 0)
        self.dispatches = self.recalibrations = 0
        self._build(tc)
        # SVD units a leaf's refresh takes: its stacked elements
        self._units = [math.prod(p.shape[:-2]) for p in tree_leaves(params)]
        device = tree_leaves(params)[0].device
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        # the thread takes its creator's intra-op thread count, so a refresh
        # computes on it what it computes on the caller's thread
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="galore-refresh",
            initializer=torch.set_num_threads, initargs=(torch.get_num_threads(),))
        self._future = None
        self._pending = None
        self._prev_batch = None
        self.history: list[dict] = []

    def _build(self, tc: TrainConfig):
        """The refresh's parts for an effective config: at start-up, and
        again after each recalibration (a refresh in flight swaps in as it
        is)."""
        cfg, params = self._cfg, self._params
        self.tc = tc
        self.gcfg = effective_galore_config(tc)
        self.idx = galore_state_index(tc)
        self.axes = M.param_axes(cfg)
        self.mgr = SubspaceManager(self.gcfg, param_axes=self.axes)
        self.sharded = bool(tc.galore_refresh_shard) and world.n_dp() > 1
        self.layout = (ZeroLayout(params, self.gcfg, param_axes=self.axes) if self.gcfg.zero
                       else None)
        self._grads = make_refresh_grads(cfg, tc)
        self._swap = make_swap_step(cfg, tc)
        self._cold = make_refresh_step(cfg, tc)
        self._due = make_due(tc, params)

    def _recalibrate(self):
        tc = with_calibrated_costs(self._cfg, self.tc, self._params)
        self.recalibrations += 1
        log(f"[train] recalibrated {len(tc.galore.unit_costs)} SVD unit costs "
            f"(#{self.recalibrations}): " + ", ".join(
                f"{k}={v * 1e3:.1f}ms" for k, v in tc.galore.unit_costs))
        self._build(tc)

    # -- the pending buffer --------------------------------------------------

    @property
    def in_flight(self) -> bool:
        return self._future is not None or self._pending is not None

    @property
    def pending(self):
        """The pending buffer (waiting for the thread when it is still
        refreshing), or None."""
        self._join()
        return self._pending

    @pending.setter
    def pending(self, value):
        self._join()
        self._pending = value

    def restore_pending(self, pending):
        """Re-arm a checkpointed in-flight refresh: it swaps in at the next
        maybe_refresh, as in the interrupted run."""
        self.pending = pending

    def prime_stale(self, batch):
        """The stale-gradient batch of the first step after a resume (the
        previous step's, as the uninterrupted run would have held)."""
        self._prev_batch = batch

    def reset(self):
        """Drop an in-flight refresh and the stale batch (a rollback). A
        thread that failed re-raises here."""
        self.pending = None
        self._prev_batch = None

    def flush(self, opt_state, params):
        """Install any in-flight refresh (end of training)."""
        return self._swap_if_pending(opt_state, params)

    def close(self):
        self._pool.shutdown(wait=True)

    # -- the step boundary -----------------------------------------------------

    def maybe_refresh(self, params, opt_state, batch, step):
        opt_state = self._swap_if_pending(opt_state, params)
        stale = self._prev_batch if self._prev_batch is not None else batch
        self._prev_batch = batch
        is_due, arg = self._due(opt_state[self.idx], step)
        if step == 0:  # synchronous cold start
            return self._cold(params, opt_state, batch, arg)
        if is_due:
            sub = {k: v for k, v in opt_state[self.idx].items() if k != "inner"}
            self._dispatch(params, sub, stale, arg)
            self.dispatches += 1
            if self.recal_every and self.dispatches % self.recal_every == 0:
                self._recalibrate()
        return opt_state

    def _dispatch(self, params, sub, batch, step):
        t0 = time.perf_counter()
        if self._stream is None:
            grads = self._grads(params, batch)
        else:
            main = torch.cuda.current_stream(self._stream.device)
            self._stream.wait_stream(main)  # the params as the last step left them
            with torch.cuda.stream(self._stream):
                grads = self._grads(params, batch)
            # the train step writes the params in place: not before the
            # refresh's backward has read them
            main.wait_stream(self._stream)
        if self.layout is not None:  # the buffer is the full layout
            with torch.no_grad():
                sub = dict(sub, proj=self.layout.gather_proj(sub["proj"]))
        self.history.append({"step": step if step is not None else sub["step"],
                             "dispatch_s": time.perf_counter() - t0})
        self._future = self._pool.submit(self._refresh, grads, sub, step)

    def _refresh(self, grads, sub, step):
        """The pending buffer, or under the sharded refresh (grads, sub,
        step, this rank's units, verdict) for the swap to finish."""
        t0 = time.perf_counter()

        def run():
            if self.sharded:
                return (grads, sub, step) + shard_units(self.mgr, grads, sub, step)[:2]
            return refresh_projectors_pending(grads, sub, self.gcfg, step=step,
                                              param_axes=self.axes)

        with torch.no_grad():
            if self._stream is None:
                pending = run()
            else:
                with torch.cuda.stream(self._stream):
                    pending = run()
                    self._stream.synchronize()
        return pending, time.perf_counter() - t0

    def _join(self):
        if self._future is None:
            return
        t0 = time.perf_counter()
        future, self._future = self._future, None
        pending, refresh_s = future.result()  # the thread's failure re-raises here
        wait_s = time.perf_counter() - t0
        if self.sharded:  # the owners' units summed, then the store and schedule
            grads, sub, step, pre, valid = pending
            with torch.no_grad():
                pending = refresh_projectors_pending(grads, sub, self.gcfg, step=step,
                                                     param_axes=self.axes,
                                                     precomputed=sum_units(pre), valid=valid)
        if self._stream is not None:
            main = torch.cuda.current_stream(self._stream.device)
            main.wait_stream(self._stream)
            for t in tree_leaves(pending):
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    t.record_stream(main)
        units = sum(u for u, flag in zip(self._units, tree_leaves(pending["flag"])) if flag)
        self.history[-1].update(units=units, refresh_s=refresh_s, wait_s=wait_s)
        log(f"[refresh] async step {self.history[-1]['step']}: {units} SVD units, refresh "
            f"thread {refresh_s * 1e3:.0f} ms, main thread waited {wait_s * 1e3:.0f} ms at "
            f"the swap")
        self._pending = pending

    def _swap_if_pending(self, opt_state, params):
        pending = self.pending
        if pending is None:
            return opt_state
        self._pending = None
        return self._swap(opt_state, pending, params)


def train_loop(run: RunConfig, tc: TrainConfig, cfg=None, on_step=None, params=None, data=None,
               faults=None):
    """Run the loop to `run.steps`; returns (params, opt_state, metrics, last_step).

    Resumes from the newest checkpoint in `run.ckpt_dir` (the newest valid
    one when tc.anomaly_guard), so every run that must not resume another's
    files needs a directory of its own. `params` (a tree on the run's
    device) replaces the random init from tc.seed, and `data` (anything
    with ``batch(step)``; ``state(step)`` too, to record its position in
    the checkpoints) the synthetic stream — the hooks a parity test uses to
    feed the reference's weights and batches. `faults` are fault specs
    ("kind@step[*count]" or FaultSpec, robust/faults.py); traced kinds need
    tc.anomaly_guard. `on_step(step, metrics)` sees every step that was not
    rolled back; metrics["step_s"] is its wall time, measured after the
    device finished it. In a data-parallel world (distributed/world.py) every
    rank runs this loop on the same global batches."""
    device = resolve_device(run.device)
    cfg = cfg or get_config(run.arch, smoke=run.smoke)
    if data is None:
        if cfg.family == "audio":  # as the reference's run, which fails at its first step
            raise KeyError(f"enc_frames: {cfg.name} needs batches that carry enc_frames "
                           f"(B, enc_seq, d_model); the synthetic stream makes tokens only, "
                           f"so pass data= (anything with batch(step))")
        data = SyntheticC4(DataConfig(vocab_size=cfg.vocab_size, seq_len=run.seq_len,
                                      batch_per_host=run.batch_per_host, seed=tc.seed),
                           device=device)
    guarded = bool(tc.anomaly_guard)
    injector = FaultInjector(faults) if faults else None
    if injector is not None and injector.needs_traced_hooks:
        if not guarded:
            raise ValueError("traced fault kinds require tc.anomaly_guard")
        tc = dataclasses.replace(tc, fault_hooks=True)
    # crc-checked only when guarded: recovery needs exact corruption checks,
    # and an unguarded run keeps the reference's META bytes
    ckpt = CheckpointManager(run.ckpt_dir, checksum=guarded, quantize=run.ckpt_quantize,
                             writer=world.rank() == 0)

    # a rollback with no valid checkpoint restarts from the initial params
    init_host = (tree_map(lambda t: t.detach().to("cpu", copy=True), params)
                 if params is not None and guarded else None)

    def initial_params():
        if init_host is None:
            return M.init_params(cfg, seed=tc.seed, device=device)
        return tree_map(lambda t: t.to(device, copy=True).requires_grad_(True), init_host)

    if params is None:
        params = initial_params()
    gcfg = tc.galore
    if gcfg is not None and gcfg.stagger_by_importance and not gcfg.importance_order:
        tc = with_measured_importance(cfg, tc, params, data.batch(0))
    if gcfg is not None and tc.galore_calibrate_costs:
        tc = with_calibrated_costs(cfg, tc, params)
        log(f"[train] calibrated {len(tc.galore.unit_costs)} SVD unit costs: "
            + ", ".join(f"{k}={v * 1e3:.1f}ms" for k, v in tc.galore.unit_costs))
    external = external_refresh(tc)
    gcfg_eff = effective_galore_config(tc)
    # ZeRO checkpoints: the ranks' blocks gathered to the full layout on save,
    # cut into this world's blocks on restore
    zero = ((ZeroLayout(params, gcfg_eff, param_axes=M.param_axes(cfg)), galore_state_index(tc))
            if gcfg_eff is not None and gcfg_eff.zero else None)

    def build_programs(tc_eff):
        """(train_step, opt, driver, maybe_refresh, resync) for an effective
        config: at start-up, and again on a rollback that decays the lr."""
        train_step, opt = make_train_step(cfg, tc_eff)
        driver = maybe_refresh = resync = None
        if external and tc_eff.galore_refresh_async:
            driver = AsyncRefreshDriver(cfg, tc_eff, params)
            maybe_refresh = driver.maybe_refresh
        elif external:
            maybe_refresh = make_refresh_caller(cfg, tc_eff, params)
        if guarded and tc_eff.recover_resync and external and not tc_eff.galore.adaptive_t:
            # after a rollback, projectors from the restored run's own
            # gradient (phase 0: every leaf due); adaptive T owns its schedule
            resync = make_refresh_step(cfg, tc_eff)
        return train_step, opt, driver, maybe_refresh, resync

    tc_eff = tc
    train_step, opt, driver, maybe_refresh, resync = build_programs(tc_eff)
    drivers = [driver]  # every async driver built, each closed at the end
    opt_state = opt.init(params)
    guard = recov = None
    if guarded:
        guard = init_guard_state(device)
        recov = RecoveryController(max_skips=tc.recover_max_skips,
                                   max_rollbacks=tc.recover_max_rollbacks,
                                   backoff=tc.recover_backoff)

    def try_restore(params, opt_state, guard, which):
        """(params, opt_state, guard, first step) from checkpoint `which`; a
        saved guard group is restored when guarded, a saved pending group
        (a refresh in flight at the save) re-armed in the async driver."""
        groups = ckpt.groups(which)
        target = {"params": params, "opt_state": opt_state}
        if driver is not None and "pending" in groups:
            target["pending"] = init_pending_state(params, effective_galore_config(tc))
        if guarded and "guard" in groups:
            target["guard"] = guard
        restored = ckpt.restore(which, target, zero=zero)
        start = ckpt.meta(which)["step"] + 1
        if "pending" in restored:
            driver.restore_pending(restored["pending"])
        if driver is not None and start > 0:
            driver.prime_stale(data.batch(start - 1))
        return restored["params"], restored["opt_state"], restored.get("guard", guard), start

    def state_tree(params, opt_state, guard):
        tree = {"params": params, "opt_state": opt_state}
        if driver is not None and driver.in_flight:
            tree["pending"] = driver.pending  # the in-flight refresh rides along
        if guarded:
            tree["guard"] = guard  # the monitor resumes with the run
        return tree

    def data_meta(step):
        return {"data": data.state(step)} if hasattr(data, "state") else None

    start_step = 0
    latest = ckpt.latest_valid_step() if guarded else ckpt.latest_step()
    if latest is not None:
        params, opt_state, guard, start_step = try_restore(params, opt_state, guard, latest)
        log(f"[train] resumed from step {latest}")

    ema_dt = None
    metrics = {}
    preempt_flag = os.path.join(run.ckpt_dir, "PREEMPT")
    report = {}  # step -> {"loss", "step_s"}, for run.report
    if run.report:
        ops.reset_launch_counts()
    step = start_step
    try:
        while step < run.steps:
            t0 = time.perf_counter()
            batch = data.batch(step)
            if maybe_refresh is not None:
                opt_state = maybe_refresh(params, opt_state, batch, step)
                if (injector is not None and driver is not None and driver.in_flight
                        and injector.take("corrupt_pending", step)):
                    log(f"[faults] poisoning in-flight pending buffer at step {step}")
                    driver.pending = injector.poison_pending(driver.pending)
            if guarded:
                fault = None
                if tc.fault_hooks:
                    fault = (injector.traced_fault(step, device) if injector is not None
                             else identity_fault(device))
                params, opt_state, guard, metrics = train_step(params, opt_state, guard, batch,
                                                               fault)
                ok = bool(metrics["guard_ok"])
                if not ok:
                    log(f"[guard] anomalous step {step}: update skipped "
                        f"(total skips {int(metrics['guard_skips'])})")
            else:
                ok = True
                params, opt_state, metrics = train_step(params, opt_state, batch)
            if device.type == "cuda":
                # the main stream only: an async refresh's SVDs run on a
                # stream of their own, beside the next steps
                torch.cuda.current_stream(device).synchronize()
            if recov is not None and recov.observe_step(ok):
                n = recov.start_rollback()
                ckpt.wait()  # let an in-flight save commit before choosing a target
                world.barrier()
                if tc.recover_lr_decay < 1.0:
                    tc_eff = dataclasses.replace(tc_eff, lr=tc_eff.lr * tc.recover_lr_decay)
                    if driver is not None:
                        driver.reset()  # joins the old driver's thread
                    train_step, opt, driver, maybe_refresh, resync = build_programs(tc_eff)
                    drivers.append(driver)
                elif driver is not None:
                    driver.reset()  # an in-flight refresh may be the poison
                # the checkpointed monitor only ever absorbed accepted steps, so
                # restoring it keeps the z-score armed across the rollback
                guard = init_guard_state(device)
                which = ckpt.latest_valid_step()
                if which is not None:
                    params, opt_state, guard, step = try_restore(params, opt_state, guard, which)
                else:  # nothing valid on disk: restart from the initial state
                    params = initial_params()
                    opt_state = opt.init(params)
                    step = 0
                log(f"[recover] rollback {n}/{tc.recover_max_rollbacks}: restored step "
                    f"{which}, resuming at step {step}"
                    + (f", lr -> {tc_eff.lr:.2e}" if tc.recover_lr_decay < 1.0 else ""))
                if resync is not None:
                    opt_state = resync(params, opt_state, data.batch(step),
                                       0 if tc_eff.galore.refresh_stagger else None)
                    log(f"[recover] resync: force-all refresh at step {step}")
                    if driver is not None:
                        driver.prime_stale(data.batch(step))
                continue  # re-enter the loop at the restored step
            dt = time.perf_counter() - t0
            ema_dt = dt if ema_dt is None else 0.9 * ema_dt + 0.1 * dt
            if dt > 2.0 * ema_dt and step > start_step + 3:
                log(f"[watchdog] straggler step {step}: {dt:.3f}s vs EMA {ema_dt:.3f}s")
            metrics = dict(metrics, step_s=dt)
            if step % run.log_every == 0:
                aux = (f" aux_loss {float(metrics['aux_loss']):.4f}"
                       if cfg.n_experts > 0 and "aux_loss" in metrics else "")
                log(f"[train] step {step} loss {float(metrics['loss']):.4f} "
                    f"({dt * 1e3:.0f} ms){aux}")
            if run.report:
                report[step] = {"loss": float(metrics["loss"]), "step_s": dt}
            if on_step is not None:
                on_step(step, metrics)
            if run.ckpt_every and step > 0 and step % run.ckpt_every == 0:
                ckpt.save(step, state_tree(params, opt_state, guard), extra_meta=data_meta(step),
                          zero=zero)
                if injector is not None:
                    if injector.take("corrupt_ckpt", step):
                        ckpt.wait()  # corrupt the committed files, not the tmp
                        log(f"[faults] corrupting latest checkpoint after step {step}")
                        injector.corrupt_latest(run.ckpt_dir)
                    if injector.take("kill_save", step):
                        ckpt.wait()
                        log(f"[faults] simulating kill mid-save at step {step}")
                        injector.leave_stale_tmp(run.ckpt_dir, step)
            # every rank stops at the step where any rank saw the flag
            if not world.all_true(not os.path.exists(preempt_flag)):
                log(f"[train] preemption signal at step {step}: checkpoint + exit")
                ckpt.save(step, state_tree(params, opt_state, guard), extra_meta=data_meta(step),
                          block=True, zero=zero)
                world.barrier()
                if ckpt.writer:
                    os.remove(preempt_flag)
                return params, opt_state, metrics, step
            step += 1
        if driver is not None:
            opt_state = driver.flush(opt_state, params)
        ckpt.wait()
        if run.report:
            write_report(run.report, report, params, opt_state, tc, device, maybe_refresh)
        return params, opt_state, metrics, run.steps - 1
    finally:
        for d in drivers:
            if d is not None:
                d.close()


def write_report(path, steps, params, opt_state, tc, device, maybe_refresh):
    """This rank's run report, <path>.rank<k>.json: its rank and the world's
    size, each step's loss and wall time, every kernel wrapper's launches
    (ops.launch_counts, counted from the loop's start), its galore state's
    tensor bytes (under ZeRO beside galore_zero_state_bytes at this world's
    size), the collectives it staged through host memory, the last sharded
    refresh's units and loads, and the device's peak memory."""
    gcfg = effective_galore_config(tc)
    gstate = opt_state[galore_state_index(tc)] if gcfg is not None else None
    refresh = getattr(maybe_refresh, "refresh_step", None)
    out = {"rank": world.rank(), "n_dp": world.n_dp(), "backend": world.backend(),
           "steps": {str(k): v for k, v in steps.items()}, "launches": ops.launch_counts(),
           "state_bytes": galore_state_tensor_bytes(gstate) if gstate is not None else None,
           "zero_bytes": (galore_zero_state_bytes(params, gcfg, world.n_dp())
                          if gcfg is not None and gcfg.zero else None),
           "staged": world.STAGED["calls"],
           "refresh": getattr(refresh, "last", None),
           "peak_bytes": (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
                          else None)}
    with open(f"{path}.rank{world.rank()}.json", "w") as f:
        json.dump(out, f)


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description="GaLore training launcher, PyTorch port "
                                             "(smoke-scale by default)")
    cli.add_arch_flags(ap)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adam", "adamw", "adam8bit", "adafactor", "sgd"],
                    help="adam | adamw | adam8bit (with --galore-rank: 8-bit GaLore; "
                         "without: 8-bit Adam) | adafactor (momentum 0.9) | sgd (momentum "
                         "0.9); with --galore-rank, adafactor and sgd take GaLore's "
                         "composable path (no fused kernel, fp32 moments)")
    ap.add_argument("--galore-rank", type=int, default=0)
    ap.add_argument("--galore-t", type=int, default=200)
    ap.add_argument("--galore-fused", action="store_true",
                    help="fused project→Adam→back kernel per GaLore leaf")
    ap.add_argument("--galore-fused-apply", action="store_true",
                    help="fold the weight update W ← W + η(G̃ + wd·W) into the fused "
                         "kernel (requires --galore-fused; no full-size update is written)")
    cli.add_galore_subspace_flags(ap)
    ap.add_argument("--galore-stagger-importance", action="store_true",
                    help="order stagger offsets by measured gradient norm "
                         "(AdaRankGrad-style; implies --galore-stagger)")
    ap.add_argument("--galore-external-refresh", action="store_true",
                    help="refresh projectors in a step of their own driven by the "
                         "launcher (no refresh inside the optimizer update)")
    ap.add_argument("--galore-refresh-async", action="store_true",
                    help="double-buffered async refresh: the SVDs of the due leaves run "
                         "on a host thread and a CUDA stream of their own from the previous "
                         "step's batch, and P_active <- P_next swaps at the next step "
                         "boundary (implies external refresh)")
    ap.add_argument("--galore-reproject-moments", action="store_true",
                    help="on each async buffer swap, rotate the compact Adam moments into "
                         "the new subspace (ReLoRA-style reset hygiene) instead of carrying "
                         "old-basis statistics")
    ap.add_argument("--galore-refresh-shard", action="store_true",
                    help="partition the refresh SVD work across data-parallel ranks and "
                         "gather the projectors (implies external refresh; per-refresh "
                         "ceiling Σc_i → max bin ≈ Σc_i/n_dp)")
    ap.add_argument("--galore-calibrate-costs", action="store_true",
                    help="measure per-shape SVD wall time once at startup and bin-pack the "
                         "distributed refresh on measured costs instead of the asymptotic "
                         "model")
    ap.add_argument("--galore-recalibrate-costs", type=int, default=0, metavar="N",
                    help="async refresh: re-measure SVD unit costs every N refresh "
                         "dispatches and rebuild the refresh, so bin-packing tracks cost "
                         "drift (requires --galore-refresh-async; 0 disables)")
    ap.add_argument("--galore-dp-compress", action="store_true",
                    help="all-reduce gradients in the compact r-dim domain (project per "
                         "rank, mean R, update once) instead of the full m×n domain")
    ap.add_argument("--galore-zero", type=int, default=0, choices=(0, 1, 2),
                    help="GaLore-ZeRO optimizer-state partitioning: 1 shards the persistent "
                         "compact state (moments, projectors, quantization payloads) "
                         "rank-blockwise across data-parallel ranks (~1/n_dp optimizer bytes "
                         "per rank; the sum of the owners' back-projections is the update); "
                         "2 additionally reduce-scatters compact gradients to owners (implies "
                         "--galore-dp-compress, fp32 moments only); 0 keeps state replicated")
    ap.add_argument("--galore-tp-aware-side", action="store_true",
                    help="choose the projection side from the parameter's tensor-parallel "
                         "labels instead of min(m, n): a weight with one tensor-parallel dim "
                         "projects along its replicated dim (changes numerics vs the paper's "
                         "shape rule; off by default)")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="torch.distributed backend of a world started by "
                         "torch.distributed.run (default nccl on CUDA, gloo on the CPU; "
                         "gloo lets two ranks share one card)")
    cli.add_quant_flags(ap)
    ap.add_argument("--anomaly-guard", action="store_true",
                    help="per-step anomaly guard: a non-finite loss or grad norm, or an "
                         "EMA z-score loss spike, turns the step into a no-op; with GaLore "
                         "also validates the refresh (guard_refresh)")
    ap.add_argument("--inject-fault", action="append", default=[], metavar="KIND@STEP[*N]",
                    help="deterministic fault injection (repeatable): traced kinds "
                         "nan_loss/inf_loss/spike_loss/nan_grad (require --anomaly-guard), "
                         "host kinds corrupt_pending/corrupt_ckpt/kill_save (corrupt_pending "
                         "poisons the async refresh's in-flight buffer)")
    ap.add_argument("--recover-max-skips", type=int, default=3,
                    help="consecutive guard skips before rolling back to the newest valid "
                         "checkpoint")
    ap.add_argument("--recover-max-rollbacks", type=int, default=2,
                    help="rollback budget before a hard TrainingFailure")
    ap.add_argument("--recover-lr-decay", type=float, default=1.0,
                    help="multiply the lr by this on each rollback (<1 enables)")
    ap.add_argument("--recover-resync", action="store_true",
                    help="after a rollback, one synchronous force-all projector refresh "
                         "before resuming (with an external or async refresh, fixed period)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    cli.add_ckpt_flags(ap, default_dir=DEFAULT_CKPT_DIR)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write each rank's run report (losses, step times, kernel launches, "
                         "state bytes, staged collectives) to PATH.rank<k>.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; there is no CPU fallback)")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    # the world that torch.distributed.run describes, if any: this rank's device
    device = world.init_world(device, args.dist_backend)
    galore = (GaLoreConfig(rank=args.galore_rank, update_freq=args.galore_t,
                           rank_frac=args.galore_rank_frac, adaptive_t=args.galore_adaptive_t,
                           refresh_stagger=args.galore_stagger or args.galore_stagger_importance,
                           stagger_by_importance=args.galore_stagger_importance,
                           reproject_moments=args.galore_reproject_moments,
                           tp_aware_side=args.galore_tp_aware_side,
                           quant=cli.quant_policy_from(args))
              if args.galore_rank > 0 or args.galore_rank_frac > 0 else None)
    if args.galore_fused and galore is None:
        ap.error("--galore-fused requires --galore-rank or --galore-rank-frac > 0")
    for flag in ("external_refresh", "refresh_async", "refresh_shard", "dp_compress",
                 "tp_aware_side"):
        if getattr(args, "galore_" + flag) and galore is None:
            ap.error(f"--galore-{flag.replace('_', '-')} requires --galore-rank or "
                     f"--galore-rank-frac > 0")
    if args.galore_reproject_moments and not args.galore_refresh_async:
        ap.error("--galore-reproject-moments acts on async buffer swaps; add "
                 "--galore-refresh-async")
    if args.galore_recalibrate_costs and not args.galore_refresh_async:
        ap.error("--galore-recalibrate-costs is driven by the async refresh driver; add "
                 "--galore-refresh-async")
    if args.galore_zero and galore is None:
        ap.error("--galore-zero requires --galore-rank or --galore-rank-frac > 0")
    if args.galore_zero == 2 and galore is not None and galore.quant.quantizes_moments:
        ap.error("--galore-zero 2 reduce-scatters compact gradients onto fp32 owner moments; "
                 "it cannot compose with quantized moment state (drop --quant-moments / use "
                 "--galore-zero 1)")
    if args.galore_fused_apply and not args.galore_fused:
        ap.error("--galore-fused-apply requires --galore-fused")
    if args.optimizer in ("adafactor", "sgd"):
        for flag, on in (("--galore-fused", args.galore_fused),
                         ("--quant-moments int8", args.quant_moments == "int8"),
                         ("--galore-reproject-moments", args.galore_reproject_moments)):
            if on:
                ap.error(f"{flag} needs Adam moments; --optimizer {args.optimizer} has none")
    if args.anomaly_guard and args.galore_fused_apply:
        ap.error("--anomaly-guard wraps the chain train step; --galore-fused-apply has no "
                 "guarded variant yet")
    try:
        faults = [parse_fault(s) for s in args.inject_fault]
    except ValueError as e:
        ap.error(str(e))
    if any(f.kind in TRACED_KINDS for f in faults) and not args.anomaly_guard:
        ap.error("traced fault kinds (nan_loss/inf_loss/spike_loss/nan_grad) poison the step "
                 "from inside — they require --anomaly-guard")
    if galore is not None and args.anomaly_guard:
        # the guard implies the poison-proof refresh
        galore = dataclasses.replace(galore, guard_refresh=True)
    tc = TrainConfig(optimizer=args.optimizer, galore=galore, lr=args.lr,
                     total_steps=args.steps, warmup_steps=max(1, args.steps // 10),
                     galore_fused_adam=args.galore_fused,
                     galore_fused_apply=args.galore_fused_apply,
                     galore_external_refresh=args.galore_external_refresh,
                     galore_refresh_async=args.galore_refresh_async,
                     galore_refresh_shard=args.galore_refresh_shard,
                     # ZeRO-2 reduce-scatters in the compact domain: the compress path
                     galore_dp_compress=args.galore_dp_compress or args.galore_zero == 2,
                     galore_zero=args.galore_zero,
                     galore_calibrate_costs=args.galore_calibrate_costs,
                     galore_recalibrate_every=args.galore_recalibrate_costs,
                     anomaly_guard=args.anomaly_guard,
                     recover_max_skips=args.recover_max_skips,
                     recover_max_rollbacks=args.recover_max_rollbacks,
                     recover_lr_decay=args.recover_lr_decay,
                     recover_resync=args.recover_resync)
    run = RunConfig(arch=args.arch, smoke=not args.full, steps=args.steps,
                    batch_per_host=args.batch, seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, log_every=args.log_every,
                    ckpt_quantize=args.ckpt_quantize, device=str(device), report=args.report)
    try:
        train_loop(run, tc, cfg=cli.config_from(args), faults=faults or None)
    finally:
        world.close_world()


if __name__ == "__main__":
    main()
