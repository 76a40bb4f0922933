#!/usr/bin/env python3
"""Time the fp32-moment emit GaLore step, and trace one fp32 fused training
step, of a checkout of this repository on one CUDA card.

    python3 tools/emit_profile.py [--root DIR] [--tag NAME] [--out FILE]
                                  [--phases fused,fused-apply]

--root names the checkout whose src/repro_torch is imported (default: the one
that holds this script), so that two checkouts (a parent commit unpacked with
`git archive`, and the working tree) are measured by the same code on one
card, in turns (parent, change, change, parent). Each checkout builds its
kernels into its own build/kernels.

1. Times galore_fused_adam_step[_right] (bf16 G; P f32 and packed int4): the
   median of 10 launches timed with CUDA events after 3 warm-up launches, at
   the main path's three leaves of llama_7b at r = 128 and llama_1b's three
   at r = 512 (chip_smoke.py's SHAPES and SHAPES8).
2. Runs chip_smoke.py's fp32 main path (llama_7b width, 2 layers, bf16,
   batch 8 x 256, GaLore r = 128, T = 4) for 4 steps in each of --phases —
   `fused` (the emit step, then the optimizer chain and the weight update)
   and `fused-apply` (the weight update inside the kernel) — with
   torch.profiler (CPU and CUDA activities) over step 2, a step that does
   not refresh. Prints the step's wall time beside the untraced steps 1 and
   3, the device's busy time (the union of its kernels' intervals) and idle
   share, device time by kernel kind and the top kernels by device time,
   the host operators with the most self time, and, with both phases, the
   kernels whose device time differs most between them.
Prints one JSON summary line last and writes it, with the profiler's tables,
to --out. Needs a CUDA card; imports no JAX.
"""
import argparse
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

SHAPES = [  # (side, L, m, r, n)
    ("left", 2, 4096, 128, 11008),
    ("left", 2, 4096, 128, 4096),
    ("right", 2, 11008, 128, 4096),
    ("left", 2, 2048, 512, 2048),
    ("left", 2, 2048, 512, 5461),
    ("right", 2, 5461, 512, 2048),
]
# device kernels by kind, by a fragment of the kernel's name (first match)
KINDS = [
    ("galore", ("lowrank_adam_kernel", "galore_fused_left_kernel", "galore_fused_right_kernel")),
    ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "matmul", "Kernel2")),
    ("attention", ("softmax", "flash", "attention")),
    ("cast/copy", ("copy", "Memcpy", "Memset", "fill")),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized")),
]


def cuda_ms(torch, fn, warmup=3, reps=10):
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


def time_emit(torch, gf, codec, lowrank_adam_update):
    """Section 1: {"side L m r n p": ms} of the fp32-moment emit wrappers."""
    out = {}
    for i, (side, L, m, r, n) in enumerate(SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(i)
        kept, mv = ((m, r), (r, n)) if side == "left" else ((n, r), (m, r))
        rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
        P = torch.linalg.qr(rnd(L, *kept))[0].contiguous()
        G = rnd(L, m, n).to(torch.bfloat16)
        M = V = torch.zeros(L, *mv, device="cuda")
        for t in range(1, 7):
            _, M, V = lowrank_adam_update(rnd(L, *mv), M, V, torch.tensor(t, device="cuda"))
        M, V = M.contiguous(), V.contiguous()
        count = torch.tensor(7, dtype=torch.int32, device="cuda")
        fn = gf.galore_fused_adam_step_right if side == "right" else gf.galore_fused_adam_step
        for p, Pa in (("f32", P), ("int4", codec.quant4_axis_state(P))):
            ms = cuda_ms(torch, lambda: fn(Pa, G, M, V, count, alpha=0.25))
            key = f"{side} {L} {m} {r} {n} {p}"
            out[key] = ms
            print(f"[emit] {side} L={L} (m,r,n)=({m},{r},{n}) G bfloat16 P {p}: {ms:.3f} ms",
                  flush=True)
        del P, G, M, V
    torch.cuda.empty_cache()
    return out


def kind_of(name):
    for kind, frags in KINDS:
        if any(f in name for f in frags):
            return kind
    return "other"


def trace_step(torch, repro, phase):
    """Section 2: the fp32 main path (`phase` fused or fused-apply),
    torch.profiler over step 2."""
    from torch.profiler import ProfilerActivity, profile

    GaLoreConfig, TrainConfig, get_config, RunConfig, train_loop = repro
    cfg = dataclasses.replace(get_config("llama_7b"), n_layers=2)
    tc = TrainConfig(optimizer="adamw", galore=GaLoreConfig(rank=128, update_freq=4, scale=0.25),
                     galore_fused_adam=True, galore_fused_apply=phase == "fused-apply", lr=1e-3,
                     weight_decay=0.01, total_steps=8, warmup_steps=1)
    # a checkpoint directory of its own (the launcher resumes from what it
    # finds in one), where the checkout's launcher has checkpoints
    ckpt_dir = tempfile.TemporaryDirectory()
    own = ({"ckpt_dir": ckpt_dir.name}
           if "ckpt_dir" in {f.name for f in dataclasses.fields(RunConfig)} else {})
    run = RunConfig(arch="llama_7b", smoke=False, steps=4, batch_per_host=8, seq_len=256,
                    log_every=1, device="cuda", **own)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    times = []

    def on_step(step, metrics):
        times.append(metrics["step_s"])
        if step == 1:
            prof.start()
        elif step == 2:
            prof.stop()

    train_loop(run, tc, cfg=cfg, on_step=on_step)
    ckpt_dir.cleanup()
    wall_us = times[2] * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name, by_kind = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + d)
        by_kind[kind_of(e.name)] = by_kind.get(kind_of(e.name), 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:40]
    host = prof.key_averages()
    host_top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:15]
    summary = dict(
        step_ms=times[2] * 1e3, untraced_step_ms=[times[1] * 1e3, times[3] * 1e3],
        refresh_step_ms=times[0] * 1e3, device_events=len(kernels),
        device_busy_ms=busy / 1e3, device_idle_share=(1 - busy / wall_us) if kernels else None,
        kernel_ms_by_kind={k: v / 1e3 for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        top_kernels=[dict(name=k[:120], launches=n, ms=t / 1e3) for k, (n, t) in top],
        host_self_ms=[dict(op=e.key[:80], calls=e.count, self_ms=e.self_cpu_time_total / 1e3)
                      for e in host_top])
    print(f"[trace] {phase} step 2 (non-refresh): {summary['step_ms']:.1f} ms traced "
          f"(steps 1, 3 untraced: {times[1] * 1e3:.1f}, {times[3] * 1e3:.1f} ms); "
          f"{len(kernels)} device events, device busy {busy / 1e3:.2f} ms", flush=True)
    if kernels:
        print(f"[trace] {phase} idle share {summary['device_idle_share']:.3f}; device ms by kind "
              + ", ".join(f"{k} {v:.2f}" for k, v in summary["kernel_ms_by_kind"].items()),
              flush=True)
        for row in summary["top_kernels"][:12]:
            print(f"[trace] {phase} {row['ms']:8.3f} ms {row['launches']:4d}×  {row['name']}",
                  flush=True)
    for row in summary["host_self_ms"][:10]:
        print(f"[trace] {phase} host {row['self_ms']:8.2f} ms self {row['calls']:5d}×  {row['op']}",
              flush=True)
    table = host.table(sort_by="self_cpu_time_total", row_limit=40)
    return summary, table, {k: t for k, (_, t) in by_name.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--phases", default="fused,fused-apply")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("emit_profile: no CUDA device is available")
    from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config
    from repro_torch.kernels import galore_fused as gf
    from repro_torch.kernels.ref import lowrank_adam_update
    from repro_torch.launch.train import RunConfig, train_loop
    from repro_torch.quant import codec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(f"[device] {torch.cuda.get_device_name(0)}; root {root} {args.tag}", flush=True)
    emit = time_emit(torch, gf, codec, lowrank_adam_update)
    repro = (GaLoreConfig, TrainConfig, get_config, RunConfig, train_loop)
    traces, tables, names = {}, [], {}
    for phase in args.phases.split(","):
        traces[phase], table, names[phase] = trace_step(torch, repro, phase)
        tables.append(f"[{phase}]\n{table}")
    if len(names) == 2:  # the kernels whose device time differs most between the phases
        (a, ka), (b, kb) = names.items()
        diff = {k: (ka.get(k, 0.0) - kb.get(k, 0.0)) / 1e3 for k in set(ka) | set(kb)}
        top = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:15]
        traces[f"{a} - {b}"] = dict(total_ms=sum(diff.values()),
                                    top=[dict(name=k[:120], ms=v) for k, v in top])
        print(f"[trace] {a} - {b}: device time {sum(diff.values()):+.2f} ms", flush=True)
        for k, v in top[:10]:
            print(f"[trace] {a} - {b} {v:+8.3f} ms  {k[:110]}", flush=True)
    result = dict(tag=args.tag, root=root, device=torch.cuda.get_device_name(0), emit_ms=emit,
                  trace=traces, seconds=time.perf_counter() - t0)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n" + "\n".join(tables) + "\n")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
