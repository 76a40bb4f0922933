#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each timed, none of them optional; any failed check raises:
  1. device: require CUDA, print the card's name and power limit, TF32 off;
  2. build the Hopper kernels from src/repro_torch/csrc with nvcc (sm_90a);
  3. hold every kernel against its plain PyTorch version on the card at the
     main path's shapes (and r = 1024, and a ragged shape), G in bf16 and
     f32, to 1e-5·max|want| on G̃, M' and V'; time both with CUDA events;
  4. the main path, fused: 8 GaLore-Adam steps (rank 128, T 4) of llama_7b at
     full width, 2 layers, bf16, batch 8 × 256 tokens, through train_loop;
     every loss finite, the last below the first, and each kernel launched
     once per stacked leaf per step (6 left leaves, 1 right leaf);
  5. the same run on the composable plain-torch path: no kernel launches,
     per-step losses within 5e-2 of phase 4;
  6. record: a JSON line of the kernels, step times, SVD refresh time, peak
     memory, the card's name and power limit, and last the result line.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.projector import compute_projector  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import galore_fused as gf  # noqa: E402
from repro_torch.kernels.ref import lowrank_adam_update  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 FMA FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
SOURCE = "src/repro_torch/csrc/galore_fused.cu"
KERNELS = {
    "left": dict(name="galore_fused_adam_left", wrapper=gf.galore_fused_adam_step,
                 plain=gf.galore_fused_adam_step_plain,
                 replaces="src/repro/kernels/galore_fused.py:169"),
    "right": dict(name="galore_fused_adam_right", wrapper=gf.galore_fused_adam_step_right,
                  plain=gf.galore_fused_adam_step_right_plain,
                  replaces="src/repro/kernels/galore_fused.py:268"),
}
# (side, L, m, r, n, on the main path): the slice's leaves at llama_7b width
# with 2 layers, the paper's 7B rank, and a ragged shape
SHAPES = [
    ("left", 2, 4096, 128, 4096, True),     # wq wk wv wo
    ("left", 2, 4096, 128, 11008, True),    # gate up
    ("left", 1, 4096, 1024, 11008, False),
    ("left", 1, 1000, 96, 520, False),
    ("right", 2, 11008, 128, 4096, True),   # down
    ("right", 1, 11008, 1024, 4096, False),
    ("right", 1, 1000, 96, 520, False),
]
ALPHA, COUNT = 0.25, 7


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup, reps):
    """Median time of fn() on the card, from CUDA events around each call."""
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


def kernel_inputs(side, L, m, r, n, g_dtype, seed):
    """Inputs of step COUNT: P with orthonormal columns (as a GaLore
    projector), G, and M/V left by COUNT - 1 earlier Adam steps on compact
    gradients of R's scale. Moments drawn independently of each other (a
    tiny V beside a non-zero M, which no Adam run produces) make N̂ so
    sensitive to R that two f32 summation orders differ by more than
    1e-5·max|G̃| — and either differs that much from an f64 reference."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kept, mv = ((m, r), (r, n)) if side == "left" else ((n, r), (m, r))
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    P = torch.linalg.qr(rnd(L, *kept))[0].contiguous()
    G = rnd(L, m, n).to(g_dtype)
    M = torch.zeros(L, *mv, device="cuda")
    V = torch.zeros(L, *mv, device="cuda")
    for t in range(1, COUNT):
        _, M, V = lowrank_adam_update(rnd(L, *mv), M, V, torch.tensor(t, device="cuda"))
    return P, G, M, V, torch.tensor(COUNT, dtype=torch.int32, device="cuda")


def bound(side, L, m, r, n, g_itemsize):
    """Least time (s) for one launch, and what bounds it: each input read once
    and each output written once, and the f32 operations of the two
    contractions plus the elementwise Adam."""
    kept = m if side == "left" else n
    mv = L * r * (n if side == "left" else m)
    nbytes = 4 * L * kept * r + g_itemsize * L * m * n + 4 * 4 * mv + 4 * L * m * n
    flops = 4 * L * m * r * n + 12 * mv
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_F32
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels():
    rows = []
    for i, (side, L, m, r, n, main) in enumerate(SHAPES):
        k = KERNELS[side]
        for dt in (torch.bfloat16, torch.float32):
            P, G, M, V, count = kernel_inputs(side, L, m, r, n, dt, seed=i)
            want = k["plain"](P, G, M, V, count, alpha=ALPHA)
            got = k["wrapper"](P, G, M.clone(), V.clone(), count, alpha=ALPHA)
            torch.cuda.synchronize()
            errs = []
            for name, a, b in zip(("update", "m", "v"), got, want):
                tol = 1e-5 * b.abs().max() + 1e-5 * b.abs()
                diff = (a - b).abs()
                if bool((diff > tol).any()) or not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"{k['name']} {side} L={L} (m,r,n)=({m},{r},{n}) {dt} "
                                         f"{name}: max|err| {float(diff.max()):.3e} over tolerance "
                                         f"(1e-5·max|want| = {float(1e-5 * b.abs().max()):.3e})")
                errs.append(float(diff.max()))
            Mw, Vw = M.clone(), V.clone()
            ms = cuda_ms(lambda: k["wrapper"](P, G, Mw, Vw, count, alpha=ALPHA), 3, 10)
            plain_ms = cuda_ms(lambda: k["plain"](P, G, M, V, count, alpha=ALPHA), 2, 5)
            b_s, b_by = bound(side, L, m, r, n, G.element_size())
            row = dict(side=side, L=L, m=m, r=r, n=n, g_dtype=str(dt).removeprefix("torch."),
                       main_path=main, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                       bound_ms=b_s * 1e3, bound_by=b_by)
            rows.append(row)
            log(f"[kernels] {k['name']:24s} L={L} (m,r,n)=({m},{r},{n}) G {row['g_dtype']:8s} "
                f"max|err| G̃/M'/V' {errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e} ok  "
                f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  bound {b_s * 1e3:.3f} ms ({b_by})")
            del P, G, M, V, Mw, Vw, got, want
    torch.cuda.empty_cache()
    return rows


def train_phase(fused):
    cfg = dataclasses.replace(get_config("llama_7b"), n_layers=2)
    tc = TrainConfig(optimizer="adamw", galore=GaLoreConfig(rank=128, update_freq=4, scale=0.25),
                     galore_fused_adam=fused, lr=1e-3, total_steps=8, warmup_steps=1)
    run = RunConfig(arch="llama_7b", smoke=False, steps=8, batch_per_host=8, seq_len=256,
                    log_every=1, device="cuda")
    losses, times = [], []

    def on_step(step, metrics):
        losses.append(float(metrics["loss"]))
        times.append(metrics["step_s"])

    torch.cuda.reset_peak_memory_stats()
    gf.reset_launch_counts()
    train_loop(run, tc, cfg=cfg, on_step=on_step)
    launches = {"left": gf.galore_fused_adam_step.launches,
                "right": gf.galore_fused_adam_step_right.launches}
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    return losses, times, launches, peak


def svd_ms():
    """The refresh's SVD on the card at the slice's two projector shapes."""
    out = {}
    for m, n in ((4096, 4096), (4096, 11008)):
        G = torch.randn(m, n, device="cuda")
        out[f"{m}x{n}"] = cuda_ms(lambda: compute_projector(G, 128), 1, 3)
    return out


def main():
    t_all = time.perf_counter()
    t = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s) ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    libs = build.build(["galore_fused"])
    log(f"[build] nvcc sm_90a: {', '.join(p.name for p in libs.values())} "
        f"({time.perf_counter() - t:.1f} s)")
    for path in libs.values():
        report = path.with_name(path.name + ".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {line.strip()}")

    t = time.perf_counter()
    rows = check_kernels()
    log(f"[kernels] {len(rows)} checks passed ({time.perf_counter() - t:.1f} s)")

    t = time.perf_counter()
    f_loss, f_times, f_launch, f_peak = train_phase(fused=True)
    log(f"[fused] losses {[round(x, 4) for x in f_loss]} launches {f_launch} "
        f"({time.perf_counter() - t:.1f} s)")
    if not f_loss[-1] < f_loss[0]:
        raise AssertionError(f"loss did not decrease: {f_loss}")
    if f_launch != {"left": 48, "right": 8}:
        raise AssertionError(f"main path launches {f_launch}, want left 48 (6 leaves × 8 steps), "
                             f"right 8 (1 leaf × 8 steps)")

    t = time.perf_counter()
    c_loss, c_times, c_launch, c_peak = train_phase(fused=False)
    log(f"[composable] losses {[round(x, 4) for x in c_loss]} launches {c_launch} "
        f"({time.perf_counter() - t:.1f} s)")
    if c_launch != {"left": 0, "right": 0}:
        raise AssertionError(f"the composable path launched kernels: {c_launch}")
    gap = max(abs(a - b) for a, b in zip(f_loss, c_loss))
    if gap > 5e-2:
        raise AssertionError(f"fused vs composable losses differ by {gap:.3e} > 5e-2")
    log(f"[parity] fused vs composable max |Δloss| {gap:.3e} (limit 5e-2)")

    t = time.perf_counter()
    svd = svd_ms()
    shapes = ", ".join(f"{k} {v:.1f} ms" for k, v in svd.items())
    log(f"[svd] torch.linalg.svd f32, rank-128 projector: {shapes} "
        f"({time.perf_counter() - t:.1f} s)")
    for tag, times, peak in (("fused", f_times, f_peak), ("composable", c_times, c_peak)):
        steady = statistics.median(times[i] for i in range(len(times)) if i % 4)
        log(f"[steps] {tag}: step ms {[round(x * 1e3, 1) for x in times]}; median non-refresh "
            f"{steady * 1e3:.1f} ms; refresh steps 0/4 {times[0] * 1e3:.1f}/"
            f"{times[4] * 1e3:.1f} ms; peak memory {peak / 2**30:.2f} GiB")

    kernels = []
    for side, k in KERNELS.items():
        mine = [r for r in rows if r["side"] == side]
        main_bf16 = [r for r in mine if r["main_path"] and r["g_dtype"] == "bfloat16"]
        top = max(main_bf16, key=lambda r: r["m"] * r["n"])
        kernels.append(dict(
            name=k["name"], route="cuda", source=SOURCE, replaces=k["replaces"],
            launches=f_launch[side],
            max_abs_err=max(r["max_abs_err"] for r in mine if r["main_path"]),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
            bound_by=top["bound_by"], library_ms=None,
            shape=dict(L=top["L"], m=top["m"], r=top["r"], n=top["n"], g_dtype="bfloat16"),
            shapes=mine))
    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
