"""Training launcher (port of repro/launch/train.py without its refresh
drivers).

Takes GaLore (or full-rank) Adam steps on a synthetic C4-like stream and logs
``[train] step N loss …``. Runs on ``cuda`` unless ``--device`` says
otherwise. Ported with the loop:
  * checkpoints every ``--ckpt-every`` steps (async, atomic; crc-checked and
    carrying the guard's state when guarded; ``--ckpt-quantize`` for the
    params' file codec) with the pipeline's position in META, and
    auto-resume from the newest checkpoint (the newest VALID one when
    guarded) in ``--ckpt-dir``;
  * preemption: touch <ckpt_dir>/PREEMPT to save (blocking) and return;
  * the anomaly guard (``--anomaly-guard``): a non-finite or spiking step is
    a no-op, and with GaLore a non-finite gradient voids the refresh and a
    failed SVD falls back to the randomized projector (guard_refresh);
  * fault injection (``--inject-fault``) and escalation (``--recover-*``):
    K consecutive skips roll back to the newest valid checkpoint (or to the
    initial state), a bounded number of times, then TrainingFailure;
  * the straggler watchdog line (a step over twice the EMA step time).
Still missing: the external, sharded and async refresh modes (so
``--recover-resync`` has nothing to resync, and a saved ``pending`` group is
not restored, as the reference does without its async driver) and the
subspace lifecycle extras (per-leaf ranks, stagger, adaptive T, moment
re-projection, SVD cost calibration).

CLI:  PYTHONPATH=src python -m repro_torch.launch.train --arch llama_60m --steps 20 \\
          --galore-rank 16 --galore-t 10 --galore-fused --ckpt-dir /path/to/ckpt
      (add --quant-moments int8 --quant-proj int4 for 8-bit GaLore, and
      --galore-fused-apply to fold the weight update into the kernel;
      --optimizer adam8bit without --galore-rank is the 8-bit Adam baseline;
      --anomaly-guard --inject-fault nan_grad@5*3 --ckpt-every 4 drives a
      rollback)
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticC4
from repro_torch.distributed.step import make_train_step
from repro_torch.launch import cli
from repro_torch.models import model as M
from repro_torch.robust import (
    TRACED_KINDS,
    FaultInjector,
    RecoveryController,
    identity_fault,
    init_guard_state,
    parse_fault,
)
from repro_torch.utils import resolve_device, tree_map

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
    device finished it."""
    device = resolve_device(run.device)
    cfg = cfg or get_config(run.arch, smoke=run.smoke)
    if data is None:
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
    ckpt = CheckpointManager(run.ckpt_dir, checksum=guarded, quantize=run.ckpt_quantize)

    # a rollback with no valid checkpoint restarts from the initial params
    init_host = (tree_map(lambda t: t.detach().to("cpu", copy=True), params)
                 if params is not None and guarded else None)

    def initial_params():
        if init_host is None:
            return M.init_params(cfg, seed=tc.seed, device=device)
        return tree_map(lambda t: t.to(device, copy=True).requires_grad_(True), init_host)

    if params is None:
        params = initial_params()
    tc_eff = tc
    train_step, opt = make_train_step(cfg, tc_eff)
    opt_state = opt.init(params)
    guard = recov = None
    if guarded:
        guard = init_guard_state(device)
        recov = RecoveryController(max_skips=tc.recover_max_skips,
                                   max_rollbacks=tc.recover_max_rollbacks,
                                   backoff=tc.recover_backoff)

    def try_restore(params, opt_state, guard, which):
        """(params, opt_state, guard, first step) from checkpoint `which`; a
        saved guard group is restored when guarded, a pending group never."""
        target = {"params": params, "opt_state": opt_state}
        if guarded and "guard" in ckpt.groups(which):
            target["guard"] = guard
        restored = ckpt.restore(which, target)
        return (restored["params"], restored["opt_state"], restored.get("guard", guard),
                ckpt.meta(which)["step"] + 1)

    def state_tree(params, opt_state, guard):
        tree = {"params": params, "opt_state": opt_state}
        if guarded:
            tree["guard"] = guard  # the monitor resumes with the run
        return tree

    def data_meta(step):
        return {"data": data.state(step)} if hasattr(data, "state") else None

    start_step = 0
    latest = ckpt.latest_valid_step() if guarded else ckpt.latest_step()
    if latest is not None:
        params, opt_state, guard, start_step = try_restore(params, opt_state, guard, latest)
        print(f"[train] resumed from step {latest}")

    ema_dt = None
    metrics = {}
    preempt_flag = os.path.join(run.ckpt_dir, "PREEMPT")
    step = start_step
    while step < run.steps:
        t0 = time.perf_counter()
        batch = data.batch(step)
        if guarded:
            fault = None
            if tc.fault_hooks:
                fault = (injector.traced_fault(step, device) if injector is not None
                         else identity_fault(device))
            params, opt_state, guard, metrics = train_step(params, opt_state, guard, batch, fault)
            ok = bool(metrics["guard_ok"])
            if not ok:
                print(f"[guard] anomalous step {step}: update skipped "
                      f"(total skips {int(metrics['guard_skips'])})")
        else:
            ok = True
            params, opt_state, metrics = train_step(params, opt_state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if recov is not None and recov.observe_step(ok):
            n = recov.start_rollback()
            ckpt.wait()  # let an in-flight save commit before choosing a target
            if tc.recover_lr_decay < 1.0:
                tc_eff = dataclasses.replace(tc_eff, lr=tc_eff.lr * tc.recover_lr_decay)
                train_step, opt = make_train_step(cfg, tc_eff)
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
            print(f"[recover] rollback {n}/{tc.recover_max_rollbacks}: restored step {which}, "
                  f"resuming at step {step}"
                  + (f", lr -> {tc_eff.lr:.2e}" if tc.recover_lr_decay < 1.0 else ""))
            continue  # re-enter the loop at the restored step
        dt = time.perf_counter() - t0
        ema_dt = dt if ema_dt is None else 0.9 * ema_dt + 0.1 * dt
        if dt > 2.0 * ema_dt and step > start_step + 3:
            print(f"[watchdog] straggler step {step}: {dt:.3f}s vs EMA {ema_dt:.3f}s")
        metrics = dict(metrics, step_s=dt)
        if step % run.log_every == 0:
            print(f"[train] step {step} loss {float(metrics['loss']):.4f} ({dt * 1e3:.0f} ms)")
        if on_step is not None:
            on_step(step, metrics)
        if run.ckpt_every and step > 0 and step % run.ckpt_every == 0:
            ckpt.save(step, state_tree(params, opt_state, guard), extra_meta=data_meta(step))
            if injector is not None:
                if injector.take("corrupt_ckpt", step):
                    ckpt.wait()  # corrupt the committed files, not the tmp
                    print(f"[faults] corrupting latest checkpoint after step {step}")
                    injector.corrupt_latest(run.ckpt_dir)
                if injector.take("kill_save", step):
                    ckpt.wait()
                    print(f"[faults] simulating kill mid-save at step {step}")
                    injector.leave_stale_tmp(run.ckpt_dir, step)
        if os.path.exists(preempt_flag):
            print(f"[train] preemption signal at step {step}: checkpoint + exit")
            ckpt.save(step, state_tree(params, opt_state, guard), extra_meta=data_meta(step),
                      block=True)
            os.remove(preempt_flag)
            return params, opt_state, metrics, step
        step += 1
    ckpt.wait()
    return params, opt_state, metrics, run.steps - 1


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description="GaLore training launcher, PyTorch port "
                                             "(smoke-scale by default)")
    ap.add_argument("--arch", default="llama_60m")
    ap.add_argument("--full", action="store_true", help="full-size config (default smoke)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--optimizer", default="adamw",
                    help="adam | adamw | adam8bit (with --galore-rank: 8-bit GaLore; "
                         "without: 8-bit Adam)")
    ap.add_argument("--galore-rank", type=int, default=0)
    ap.add_argument("--galore-t", type=int, default=200)
    ap.add_argument("--galore-fused", action="store_true",
                    help="fused project→Adam→back kernel per GaLore leaf")
    ap.add_argument("--galore-fused-apply", action="store_true",
                    help="fold the weight update W ← W + η(G̃ + wd·W) into the fused "
                         "kernel (requires --galore-fused; no full-size update is written)")
    cli.add_quant_flags(ap)
    ap.add_argument("--anomaly-guard", action="store_true",
                    help="per-step anomaly guard: a non-finite loss or grad norm, or an "
                         "EMA z-score loss spike, turns the step into a no-op; with GaLore "
                         "also validates the refresh (guard_refresh)")
    ap.add_argument("--inject-fault", action="append", default=[], metavar="KIND@STEP[*N]",
                    help="deterministic fault injection (repeatable): traced kinds "
                         "nan_loss/inf_loss/spike_loss/nan_grad (require --anomaly-guard), "
                         "host kinds corrupt_ckpt/kill_save (corrupt_pending needs the "
                         "async refresh, which is not ported, and never fires)")
    ap.add_argument("--recover-max-skips", type=int, default=3,
                    help="consecutive guard skips before rolling back to the newest valid "
                         "checkpoint")
    ap.add_argument("--recover-max-rollbacks", type=int, default=2,
                    help="rollback budget before a hard TrainingFailure")
    ap.add_argument("--recover-lr-decay", type=float, default=1.0,
                    help="multiply the lr by this on each rollback (<1 enables)")
    ap.add_argument("--recover-resync", action="store_true",
                    help="force a refresh after a rollback; it acts on the external refresh, "
                         "which is not ported, so it changes nothing here (as in the "
                         "reference without one)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    cli.add_ckpt_flags(ap, default_dir=DEFAULT_CKPT_DIR)
    ap.add_argument("--log-every", type=int, default=10)
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
    galore = (GaLoreConfig(rank=args.galore_rank, update_freq=args.galore_t,
                           quant=cli.quant_policy_from(args))
              if args.galore_rank > 0 else None)
    if args.galore_fused and galore is None:
        ap.error("--galore-fused requires --galore-rank > 0")
    if args.galore_fused_apply and not args.galore_fused:
        ap.error("--galore-fused-apply requires --galore-fused")
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
                     anomaly_guard=args.anomaly_guard,
                     recover_max_skips=args.recover_max_skips,
                     recover_max_rollbacks=args.recover_max_rollbacks,
                     recover_lr_decay=args.recover_lr_decay,
                     recover_resync=args.recover_resync)
    run = RunConfig(arch=args.arch, smoke=not args.full, steps=args.steps,
                    batch_per_host=args.batch, seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                    ckpt_every=args.ckpt_every, log_every=args.log_every,
                    ckpt_quantize=args.ckpt_quantize, device=str(device))
    train_loop(run, tc, faults=faults or None)


if __name__ == "__main__":
    main()
