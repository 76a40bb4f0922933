"""Hill-climb runner: the dry run of one cell under config overrides (port of
repro/launch/hillclimb.py), recorded under a tag.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch qwen2_7b --shape train_4k --tag scores_remat --set remat=scores

``--set k=v`` replaces ModelConfig fields (ints and floats parsed as such):
``remat`` takes any of the reference's policies, none, full, scores and
names (models/remat.py); ``microbatch`` among them sets the train cell's
accumulation factor.
``--optimizer`` and ``--galore-dp`` (the compressed step, no accumulation) as
the reference's. ``--rules`` takes the six rule variants of launch/mesh.py
and runs the cell as rank 0 of the pod's mesh (``--mesh single``, the
reference's, unless ``--mesh multi``); with neither flag the cell runs on
one card.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import VARIANTS


def parse_overrides(pairs) -> dict:
    """["k=v", …] -> {k: v}, v an int or float where it parses as one."""
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.hillclimb")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--rules", default=None, choices=VARIANTS)
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--galore-dp", action="store_true")
    ap.add_argument("--set", nargs="*", default=[], help="cfg field overrides k=v")
    ap.add_argument("--out", default="results/perf_torch.json")
    args = ap.parse_args(argv)

    overrides = parse_overrides(args.set)
    microbatch = overrides.pop("microbatch", None)
    mesh = args.mesh or ("single" if args.rules else None)
    rec = dryrun.run_cell(args.arch, args.shape, optimizer=args.optimizer,
                          microbatch=microbatch, overrides=overrides, galore_dp=args.galore_dp,
                          mesh=mesh, rules_name=args.rules or "baseline")
    rec["tag"] = args.tag
    rec["overrides"] = dict(overrides, **({} if microbatch is None else {"microbatch": microbatch}))
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    results[f"{args.arch}|{args.shape}|{args.tag}"] = rec
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    mem = rec.get("memory", {})
    print(f"[hillclimb] {args.tag}: status={rec['status']} "
          f"peak={mem.get('peak_bytes_per_device', 0) / 2**30:.2f} GiB "
          f"hbm_ok={rec.get('hbm_ok')} flops={rec.get('raw_cost', {}).get('flops', 0):.3e} "
          f"useful={rec.get('useful_flops_ratio')}")
    return rec


if __name__ == "__main__":
    main()
