"""Training launcher (port of the plain loop of repro/launch/train.py).

Takes a few steps of GaLore (or full-rank) Adam on a synthetic C4-like
stream and logs ``[train] step N loss …``. Runs on ``cuda`` unless
``--device`` says otherwise. Checkpoints, the anomaly guard, and the
external / sharded / async refresh modes are not ported yet.

CLI:  PYTHONPATH=src python -m repro_torch.launch.train --arch llama_60m --steps 20 \
          --galore-rank 16 --galore-t 10 --galore-fused
      (add --quant-moments int8 --quant-proj int4 for 8-bit GaLore, and
      --galore-fused-apply to fold the weight update into the kernel;
      --optimizer adam8bit without --galore-rank is the 8-bit Adam baseline)
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticC4
from repro_torch.distributed.step import make_train_step
from repro_torch.launch import cli
from repro_torch.models import model as M
from repro_torch.utils import resolve_device


@dataclasses.dataclass
class RunConfig:
    arch: str = "llama_60m"
    smoke: bool = True
    steps: int = 200
    batch_per_host: int = 8
    seq_len: int = 256
    log_every: int = 10
    device: str | None = None  # None -> cuda, and an error when there is none


def train_loop(run: RunConfig, tc: TrainConfig, cfg=None, on_step=None, params=None, data=None):
    """Run `run.steps` training steps; returns (params, opt_state, metrics, last_step).

    `params` (a tree on the run's device) replaces the random init from
    tc.seed, and `data` (anything with ``batch(step)``) the synthetic stream —
    the hooks a parity test uses to feed the reference's weights and batches.
    `on_step(step, metrics)` sees every step; metrics["step_s"] is the step's
    wall time, measured after the device finished it."""
    device = resolve_device(run.device)
    cfg = cfg or get_config(run.arch, smoke=run.smoke)
    if data is None:
        data = SyntheticC4(DataConfig(vocab_size=cfg.vocab_size, seq_len=run.seq_len,
                                      batch_per_host=run.batch_per_host, seed=tc.seed),
                           device=device)
    if params is None:
        params = M.init_params(cfg, seed=tc.seed, device=device)
    train_step, opt = make_train_step(cfg, tc)
    opt_state = opt.init(params)
    metrics = {}
    for step in range(run.steps):
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, data.batch(step))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        metrics = dict(metrics, step_s=time.perf_counter() - t0)
        if step % run.log_every == 0:
            print(f"[train] step {step} loss {float(metrics['loss']):.4f} "
                  f"({metrics['step_s'] * 1e3:.0f} ms)")
        if on_step is not None:
            on_step(step, metrics)
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
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
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
    tc = TrainConfig(optimizer=args.optimizer, galore=galore, lr=args.lr,
                     total_steps=args.steps, warmup_steps=max(1, args.steps // 10),
                     galore_fused_adam=args.galore_fused,
                     galore_fused_apply=args.galore_fused_apply)
    run = RunConfig(arch=args.arch, smoke=not args.full, steps=args.steps,
                    batch_per_host=args.batch, seq_len=args.seq, log_every=args.log_every,
                    device=str(device))
    train_loop(run, tc)


if __name__ == "__main__":
    main()
