#!/usr/bin/env python3
"""Run some of chip_smoke.py's model-family and data-parallel phases alone on
the card.

    python3 tools/chip_phases.py [moe-kernels|moe|moe-dispatch|mrope|serve-chunk|families|
                                  ssm|hybrid|whisper|dp-kernels|dp ...]

With no argument every one of them runs, in chip_smoke.py's order. Each
phase is timed; a failing phase prints its traceback and the next one
runs, so one call finds every phase's fault. The GaLore kernel library is
built only when a phase that launches it is named. Needs a CUDA card.
"""
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(only):
    if not torch.cuda.is_available():
        raise SystemExit("chip_phases: no CUDA device is available")
    t0 = time.perf_counter()
    print(cs.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not only or {"moe-kernels", "moe", "mrope", "ssm", "whisper", "dp-kernels", "dp"} & set(
            only):
        t = time.perf_counter()
        cs.build.build(["galore_epilogue", "galore_project"])
        print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    none = {name: 0 for name in cs.COUNTERS}
    phases, failed = {}, []
    for tag, fn in (("moe-kernels", cs.check_expert_apply),
                    ("moe", lambda: cs.moe_phase(phases, none)),
                    ("moe-dispatch", cs.moe_dispatch_phase),
                    ("mrope", lambda: cs.mrope_phase(phases, none)),
                    ("serve-chunk", cs.serve_chunk_phase),
                    ("families", cs.families_phase),
                    ("ssm", lambda: cs.ssm_phase(phases, none)),
                    ("hybrid", lambda: cs.hybrid_phase(phases, none)),
                    ("whisper", lambda: cs.whisper_phase(phases, none)),
                    ("dp-kernels", cs.check_rank_blocks),
                    ("dp", cs.dp_phase)):
        if only and tag not in only:
            continue
        t = time.perf_counter()
        try:
            fn()
            print(f"[{tag}] ok ({time.perf_counter() - t:.1f} s)", flush=True)
        except Exception as e:
            traceback.print_exc()
            failed.append(tag)
            print(f"[{tag}] FAILED {type(e).__name__}: {str(e)[:500]} "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)
        torch.cuda.empty_cache()
    print(f"[done] {time.perf_counter() - t0:.1f} s; failed: {failed or 'none'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
