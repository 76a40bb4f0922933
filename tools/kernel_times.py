#!/usr/bin/env python3
"""Time the flat 8-bit Adam kernel (B3-flat) and RMSNorm (B6) of a checkout of
this repository by their device time, and the 8-bit Adam baseline's step, on
one CUDA card.

    python3 tools/kernel_times.py [--root DIR] [--tag NAME] [--out FILE]
                                  [--steps N]

--root names the checkout whose src/repro_torch is imported (default: the one
that holds this script), so that two checkouts (a parent commit unpacked with
`git archive`, and the working tree) are measured by the same code on one
card, in turns (parent, change, change, parent). Each checkout builds its
kernels into its own build/kernels.

1. B3-flat (`adam8bit_update`, bf16 g, the moments six plain steps leave) at
   chip_smoke.py's FLAT_SHAPES, and B6 (`rmsnorm`, x and scale both bf16 or
   both f32) at its RMSNORM_SHAPES beside `torch.nn.functional.rms_norm`.
   Each gets three times:
   - device ms: one pair of CUDA events around n back-to-back calls queued
     behind a sleep kernel that outlasts their enqueueing, so the span holds
     the device's work and none of the host's, over n; the calls rotate over
     copies of the inputs that together exceed the 50 MB L2 (at most 64);
   - call ms: the median of single calls between two events, the host's
     time in the wrapper included (chip_smoke.py's `cuda_ms`);
   - host ms (B6 and F.rms_norm): time.perf_counter over 1000 calls with no
     synchronisation, over 1000, the least of 5 such batches.
2. The 8-bit Adam baseline (`--optimizer adam8bit`, no GaLore) at
   chip_smoke.py's main path (llama_7b width, 2 layers, bf16, batch 8 x 256,
   lr 1e-3, wd 0.01) for --steps steps: the step times and their median
   after step 0.
Prints one JSON summary line last and writes it to --out. Needs a CUDA card;
imports no JAX. chip_smoke.py takes its timers (cuda_ms, device_ms) from
here.
"""
import argparse
import dataclasses
import json
import math
import os
import statistics
import sys
import tempfile
import time

import torch

FLAT_SHAPES = [(32000, 4096), (2, 4096, 11008), (2, 4096, 4096), (2, 4096), (4096,),
               (1000, 520)]
RMSNORM_SHAPES = [(8, 256, 4096), (1000, 520)]
COUNT = 7
L2_BYTES = 50e6


def copies_for(nbytes):
    """Copies of a call's inputs whose bytes together exceed twice the L2."""
    return max(1, min(64, math.ceil(2 * L2_BYTES / nbytes)))


def cuda_ms(fn, warmup=3, reps=10):
    """Median time of fn() on the card, from CUDA events around each call
    (for a short kernel this "call" time holds the host's time in the
    wrapper too)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fns, n):
    """Device time of one call, in ms: one pair of CUDA events around n calls
    of fns (each on its own copy of the inputs, called in turn) back to back,
    with no synchronisation between them, over n. The calls queue behind a
    sleep kernel that outlasts their enqueueing, so the span holds the
    device's work and none of the host's."""
    for fn in fns[:3]:
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(min(n, 10)):
        fns[i % len(fns)]()
    host_s = (time.perf_counter() - t) / min(n, 10)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9 * (1.5 * host_s * n + 1e-3)))  # cycles; ≈ 2 GHz at most
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(n):
        fns[i % len(fns)]()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def reps_for(ms):
    """Back-to-back calls for device_ms: ≈ 20 ms of work, 10 to 500."""
    return max(10, min(500, int(20 / max(ms, 1e-3))))


def host_ms(fn, n=1000, batches=5):
    """Host time of one call, in ms: time.perf_counter over n calls with no
    synchronisation, over n; the least of `batches` such batches, as other
    work on the host only ever adds to it."""
    best = float("inf")
    for _ in range(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, time.perf_counter() - t)
        torch.cuda.synchronize()
    return best / n * 1e3


def flat_inputs(a8, codec, shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    numel = math.prod(shape)
    zeros = torch.zeros(numel, device="cuda")
    mom = (*codec.quantize(zeros, signed=True), *codec.quantize(zeros, signed=False))
    for t in range(1, COUNT):
        g = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
        mom = a8.adam8bit_update_plain(g, *mom, torch.tensor(t, dtype=torch.int32,
                                                              device="cuda"))[1:]
    return torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16), mom


def time_flat(a8, codec):
    out = {}
    count = torch.tensor(COUNT, dtype=torch.int32, device="cuda")
    for i, shape in enumerate(FLAT_SHAPES):
        g, mom = flat_inputs(a8, codec, shape, 400 + i)
        nbytes = 2 * g.numel() * g.element_size() + 4 * mom[0].numel() + 16 * mom[1].numel()
        sets = [(g.clone(), [t.clone() for t in mom]) for _ in range(copies_for(nbytes))]
        fns = [lambda g=g_, m=m_: a8.adam8bit_update(g, *m, count) for g_, m_ in sets]
        call = cuda_ms(fns[0])
        dev = device_ms(fns, reps_for(call))
        out[" ".join(map(str, shape))] = dict(device_ms=dev, call_ms=call, copies=len(sets))
        print(f"[flat] g {shape} bfloat16: device {dev:.4f} ms  call {call:.4f} ms  "
              f"({len(sets)} input copies)", flush=True)
        del g, mom, sets, fns
        torch.cuda.empty_cache()
    return out


def time_rmsnorm(trms):
    out = {}
    for i, shape in enumerate(RMSNORM_SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(600 + i)
        x32 = torch.randn(shape, generator=gen, device="cuda")
        s32 = 1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
        for dt in (torch.bfloat16, torch.float32):
            nbytes = 2 * x32.numel() * dt.itemsize
            xs = [x32.to(dt, copy=True) for _ in range(copies_for(nbytes))]
            scale = s32.to(dt)
            row = {}
            for name, f in (("kernel", lambda x: trms.rmsnorm(x, scale)),
                            ("F.rms_norm", lambda x: torch.nn.functional.rms_norm(
                                x, (shape[-1],), scale, 1e-6))):
                fns = [lambda x=x, f=f: f(x) for x in xs]
                call = cuda_ms(fns[0], 5, 20)
                row[name] = dict(device_ms=device_ms(fns, reps_for(call)), call_ms=call,
                                 host_ms=host_ms(fns[0]))
            key = f"{' '.join(map(str, shape))} {str(dt).removeprefix('torch.')}"
            out[key] = row
            k, lib = row["kernel"], row["F.rms_norm"]
            print(f"[rmsnorm] x {shape} {key.split()[-1]}: kernel device {k['device_ms']:.4f} ms "
                  f"call {k['call_ms']:.4f} ms host {k['host_ms']:.4f} ms; F.rms_norm device "
                  f"{lib['device_ms']:.4f} call {lib['call_ms']:.4f} host {lib['host_ms']:.4f} "
                  f"({len(xs)} input copies)", flush=True)
            del xs
    return out


def adam8bit_steps(steps):
    """Section 2: `steps` steps of the 8-bit Adam baseline at the main path."""
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.launch.train import RunConfig, train_loop

    cfg = dataclasses.replace(get_config("llama_7b"), n_layers=2)
    tc = TrainConfig(optimizer="adam8bit", galore=None, lr=1e-3, weight_decay=0.01,
                     total_steps=steps, warmup_steps=1)
    times = []
    # a checkpoint directory of its own (the launcher resumes from what it
    # finds in one), where the checkout's launcher has checkpoints
    with tempfile.TemporaryDirectory() as ckpt_dir:
        own = ({"ckpt_dir": ckpt_dir}
               if "ckpt_dir" in {f.name for f in dataclasses.fields(RunConfig)} else {})
        run = RunConfig(arch="llama_7b", smoke=False, steps=steps, batch_per_host=8,
                        seq_len=256, log_every=1, device="cuda", **own)
        train_loop(run, tc, cfg=cfg,
                   on_step=lambda step, metrics: times.append(metrics["step_s"]))
    torch.cuda.empty_cache()
    ms = [t * 1e3 for t in times]
    print(f"[adam8bit] step ms {[round(t, 2) for t in ms]}; median after step 0 "
          f"{statistics.median(ms[1:]):.2f} ms", flush=True)
    return dict(step_ms=ms, median_ms=statistics.median(ms[1:]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import adam8bit_update as a8
    from repro_torch.kernels import build
    from repro_torch.kernels import rmsnorm as trms
    from repro_torch.quant import codec

    print(f"[device] {torch.cuda.get_device_name(0)}; root {root} {args.tag}", flush=True)
    t = time.perf_counter()
    build.build(["galore_epilogue", "rmsnorm"])
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    result = dict(tag=args.tag, root=root, device=torch.cuda.get_device_name(0),
                  flat=time_flat(a8, codec), rmsnorm=time_rmsnorm(trms))
    if args.steps:
        result["adam8bit"] = adam8bit_steps(args.steps)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
