#!/usr/bin/env python3
"""Trace the async refresh's double buffer on one CUDA card (ROADMAP C.32).

    python3 tools/async_trace.py [--projectors svd,randomized] [--step 3]
                                 [--out FILE]

For each projector, chip_smoke.py's `async` configuration — llama_7b width,
2 layers, bf16, batch 8 x 256, 8-bit fused GaLore (int8 moments, int4 P),
r = 128, T = 8, staggered (2 SVD units a due step), moments re-projected,
`galore_refresh_async` — runs --step + 2 steps through train_loop, with
torch.profiler (CPU and CUDA activities, every thread) over steps --step and
--step + 1: the dispatch of the step's refresh, its train step, the refresh
thread, and the swap at the next step's start. The driver's three parts are
marked with record_function ("async.dispatch.N", "async.refresh.N",
"async.join.N": N the step whose refresh it is) and stamped with the host
clock. Reads off the trace:

1. overlap: the device time in which the refresh thread's kernels (on the
   driver's side stream) and the main stream's kernels both run;
2. the main stream's wait for the refresh's gradient: `_dispatch` enqueues
   the refresh's forward and backward on the side stream and makes the main
   stream wait for it, so the main stream idles from its last kernel before
   the dispatch to its first after it;
3. what the refresh thread blocks on: its CUDA runtime calls by time, and
   its span that no operator or runtime call covers (the GIL or Python);
4. the swap: how long `_join` waited, against how long the thread was still
   running when the join began (the thread's end less the join's start).

Prints one JSON summary line last and writes it, with the profiler's
tables, to --out. Needs a CUDA card; imports no JAX.
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNCS = ("Synchronize", "cudaMemcpy", "cuMemcpy", "cudaFree", "cuMemFree")


def union(spans):
    """The total length of the union of (start, end) intervals."""
    out, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            out += b - max(a, end)
            end = b
    return out


def intersect(xs, ys):
    """The length of (∪ xs) ∩ (∪ ys)."""
    return union(xs) + union(ys) - union(list(xs) + list(ys))


def clip(spans, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def instrumented(launcher, torch, stamps):
    """An AsyncRefreshDriver whose dispatch, thread and join run under
    record_function marks and append (name, step, start, end) host-clock
    stamps to `stamps`."""
    from torch.profiler import record_function

    class Marked(launcher.AsyncRefreshDriver):
        def _dispatch(self, params, sub, batch, step):
            t0 = time.perf_counter()
            with record_function(f"async.dispatch.{step}"):
                super()._dispatch(params, sub, batch, step)
            stamps.append(("dispatch", step, t0, time.perf_counter()))

        def _refresh(self, grads, sub, step):
            t0 = time.perf_counter()
            with record_function(f"async.refresh.{step}"):
                out = super()._refresh(grads, sub, step)
            stamps.append(("refresh", step, t0, time.perf_counter()))
            return out

        def _join(self):
            if self._future is None:
                return super()._join()
            t0, step = time.perf_counter(), self.history[-1]["step"]
            with record_function(f"async.join.{step}"):
                super()._join()
            stamps.append(("join", step, t0, time.perf_counter()))

    return Marked


def profiler(torch):
    from torch.profiler import ProfilerActivity, profile

    kw = dict(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:  # the refresh thread's operators too
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        return profile(experimental_config=cfg, **kw), True
    except (AttributeError, TypeError):
        return profile(**kw), False


def analyse(events, k):
    """The four readings of the step-`k` dispatch from a chrome trace's
    events."""
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e["name"].startswith("async.")]
    mark = {e["name"].rsplit(".", 1)[0]: e for e in ann if e["name"].endswith(f".{k}")}
    dispatches = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in ann
                  if e["name"].startswith("async.dispatch.")]
    missing = {"async.dispatch", "async.join"} - set(mark)
    if missing:
        return {"error": f"no {sorted(missing)} of step {k} in the trace"}
    disp, join = mark["async.dispatch"], mark["async.join"]
    main_tid = disp["tid"]
    runtime = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    launched_by = {e["args"]["correlation"]: e for e in runtime
                   if "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    span = lambda e: (e["ts"], e["ts"] + e.get("dur", 0))  # noqa: E731
    d0, d1 = span(disp)
    refresh = mark.get("async.refresh")
    r0, r1 = span(refresh) if refresh is not None else (0, 0)
    by = {"grad": [], "refresh": [], "main": []}
    streams = {}
    for e in kernels:
        host = launched_by.get(e["args"].get("correlation"))
        if host is None:
            continue
        tid, stream = host["tid"], e["args"].get("stream")
        if tid == main_tid and d0 <= host["ts"] <= d1:
            by["grad"].append(span(e))
            streams["side"] = stream
        elif tid == main_tid and not any(a <= host["ts"] <= b for a, b in dispatches):
            by["main"].append(span(e))
            streams.setdefault("main", stream)
        elif refresh is not None and tid == refresh["tid"] and r0 <= host["ts"] <= r1:
            by["refresh"].append(span(e))
            streams["refresh"] = stream
    out = {"streams": streams, "main_tid": main_tid}
    if refresh is not None:
        out["refresh_thread_ms"] = (r1 - r0) / 1e3
        out["refresh_kernels_busy_ms"] = union(by["refresh"]) / 1e3
        out["main_busy_in_refresh_window_ms"] = union(clip(by["main"], r0, r1)) / 1e3
        out["overlap_ms"] = intersect(by["refresh"], by["main"]) / 1e3
        rt = [e for e in runtime if e["tid"] == refresh["tid"] and r0 <= e["ts"] <= r1]
        calls = {}
        for e in rt:
            n, t = calls.get(e["name"], (0, 0.0))
            calls[e["name"]] = (n + 1, t + e.get("dur", 0))
        out["refresh_runtime_calls"] = [
            dict(name=n, calls=c, ms=t / 1e3)
            for n, (c, t) in sorted(calls.items(), key=lambda kv: -kv[1][1])[:8]]
        out["refresh_sync_ms"] = sum(t for n, (c, t) in calls.items()
                                     if any(s in n for s in SYNCS)) / 1e3
        ops = [span(e) for e in events if e.get("cat") == "cpu_op" and e["tid"] == refresh["tid"]
               and r0 <= e["ts"] <= r1]
        out["refresh_thread_ops_seen"] = len(ops)
        out["refresh_uncovered_ms"] = ((r1 - r0) - union(ops + [span(e) for e in rt])) / 1e3
    if by["grad"]:
        g0, g1 = min(a for a, _ in by["grad"]), max(b for _, b in by["grad"])
        before = [b for a, b in by["main"] if b <= g0]
        after = [a for a, b in by["main"] if a >= g0]
        out["grad_device_ms"] = (g1 - g0) / 1e3
        out["grad_busy_ms"] = union(by["grad"]) / 1e3
        if before and after:
            out["main_idle_around_grad_ms"] = (min(after) - max(before)) / 1e3
    j0, j1 = span(join)
    out["join_wait_ms"] = (j1 - j0) / 1e3
    if refresh is not None:
        out["thread_left_at_join_ms"] = max(0.0, (span(refresh)[1] - j0) / 1e3)
    out["dispatch_host_ms"] = (d1 - d0) / 1e3
    return out


def run(torch, projector, k, tables):
    from repro_torch.configs.base import GaLoreConfig, QuantPolicy, TrainConfig, get_config
    from repro_torch.launch import train as launcher

    cfg = dataclasses.replace(get_config("llama_7b"), n_layers=2)
    g = GaLoreConfig(rank=128, update_freq=8, scale=0.25, refresh_stagger=True,
                     reproject_moments=True, projector=projector,
                     quant=QuantPolicy(moments="int8", projectors="int4"))
    tc = TrainConfig(optimizer="adamw", galore=g, galore_fused_adam=True, lr=1e-3,
                     weight_decay=0.01, total_steps=8, warmup_steps=1, galore_refresh_async=True)
    ckpt = tempfile.TemporaryDirectory()
    rc = launcher.RunConfig(arch="llama_7b", smoke=False, steps=k + 2, batch_per_host=8,
                            seq_len=256, log_every=1, device="cuda", ckpt_dir=ckpt.name)
    stamps, times = [], []
    prof, all_threads = profiler(torch)
    plain, launcher.AsyncRefreshDriver = (launcher.AsyncRefreshDriver,
                                          instrumented(launcher, torch, stamps))
    tracing = [False]

    def on_step(step, metrics):
        times.append(metrics["step_s"])
        if step == k - 1:
            prof.start()
            tracing[0] = True
        elif step == k + 1 and tracing[0]:
            prof.stop()
            tracing[0] = False

    try:
        launcher.train_loop(rc, tc, cfg=cfg, on_step=on_step)
    finally:
        launcher.AsyncRefreshDriver = plain
        if tracing[0]:
            prof.stop()
        ckpt.cleanup()
    path = os.path.join(tempfile.gettempdir(), f"async_trace_{projector}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.unlink(path)
    got = analyse(events, k)
    st = {(n, s): (a, b) for n, s, a, b in stamps}
    host = {}
    if ("refresh", k) in st and ("join", k) in st and ("dispatch", k) in st:
        r0, r1 = st[("refresh", k)]
        j0, j1 = st[("join", k)]
        host = dict(thread_start_after_submit_ms=(r0 - st[("dispatch", k)][1]) * 1e3,
                    refresh_s_ms=(r1 - r0) * 1e3, join_wait_ms=(j1 - j0) * 1e3,
                    thread_left_at_join_ms=max(0.0, r1 - j0) * 1e3,
                    submit_to_join_ms=(j0 - st[("dispatch", k)][1]) * 1e3)
    tables.append(f"[{projector}]\n" + prof.key_averages().table(
        sort_by="self_cpu_time_total", row_limit=30))
    return dict(projector=projector, step=k, all_threads=all_threads,
                step_ms=[round(t * 1e3, 1) for t in times], trace=got, host_clock=host)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--projectors", default="svd,randomized")
    ap.add_argument("--step", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("async_trace: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(f"[device] {torch.cuda.get_device_name(0)}", flush=True)
    rows, tables = [], []
    for projector in args.projectors.split(","):
        row = run(torch, projector, args.step, tables)
        rows.append(row)
        print(f"[async-trace] {projector}: " + json.dumps(row), flush=True)
    result = dict(device=torch.cuda.get_device_name(0), runs=rows,
                  seconds=time.perf_counter() - t0)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n" + "\n".join(tables) + "\n")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
