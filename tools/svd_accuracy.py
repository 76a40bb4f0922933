#!/usr/bin/env python3
"""How accurate, and how fast, is the GaLore refresh's SVD on the card?

    python3 tools/svd_accuracy.py

core/projector.py::compute_projector keeps the top-r left singular vectors
of G. For each cuSOLVER driver of torch.linalg.svd (gesvd, gesvdj — what
the default ran before, gesvda) and for compute_projector itself (gesvd,
its kept columns re-orthonormalised by a QR), in f32 on the card, this
prints:
  * max |UᵀU − I| of the kept columns (0 for an orthonormal P),
  * their subspace overlap (core/projector.py::subspace_overlap) with the
    top-r left singular subspace LAPACK computes in f64 on the CPU (over the
    defined top k columns where G has rank k < r), the least over a stack,
  * the time of one call (the second, after a warm-up; CUDA events), or
    FAILED with cuSOLVER's message,
at r = 128 and 1024 (32 for the 512 x 512 case), for: a 512 x 512 gradient
with a planted rank-32 part; a Gaussian 4096 x 11008 llama_7b leaf;
the main path's own gradients (llama_7b width, 2 layers, bf16, batch 8 x 256
of the synthetic stream: wq, up and down, stacked (2, m, n), down transposed
as the refresh takes it); and a stacked (2, 4096, 4096) G of rank 64. Then
LAPACK in f32 on the CPU. Needs a CUDA card; imports no JAX.
"""
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.projector import compute_projector, subspace_overlap  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticC4  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.utils import tree_leaves, tree_leaves_with_path  # noqa: E402

DRIVERS = ("gesvd", "gesvdj", "gesvda")


def main_path_grads():
    """The first step's gradients of chip_smoke.py's main path, wq / up /
    down, as the refresh takes them (m ≤ n: down transposed)."""
    cfg = dataclasses.replace(get_config("llama_7b"), n_layers=2)
    params = M.init_params(cfg, seed=0, device="cuda")
    batch = SyntheticC4(DataConfig(vocab_size=cfg.vocab_size, seq_len=256, batch_per_host=8),
                        device="cuda").batch(0)
    loss, _ = M.loss_fn(cfg, params, batch)
    grads = dict(zip([p for p, _ in tree_leaves_with_path(params)],
                     torch.autograd.grad(loss, tree_leaves(params))))
    out = {}
    for name in ("blocks.attn.wq", "blocks.ffn.up", "blocks.ffn.down"):
        g = grads[name].detach().float()
        out[f"grad {name}"] = (g.transpose(-1, -2).contiguous() if g.shape[-2] > g.shape[-1]
                               else g, None)
    return out


def cases(seed=0):
    """name -> (G on the card, rank of G or None for full rank)."""
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((512, 32)))[0]
    V = np.linalg.qr(rng.standard_normal((512, 32)))[0]
    planted = (U * (10.0 * (1 + np.arange(32) / 8))) @ V.T
    planted += 0.1 * rng.standard_normal((512, 512)) / np.sqrt(512)
    out = {"planted 512x512 r32": (planted.astype(np.float32), None),
           "gaussian 4096x11008": (rng.standard_normal((4096, 11008), np.float32), None)}
    A = rng.standard_normal((2, 4096, 64), np.float32)
    out["rank-64 2x4096x4096"] = (A @ rng.standard_normal((2, 64, 4096), np.float32), 64)
    out = {k: (torch.from_numpy(g).cuda(), k_) for k, (g, k_) in out.items()}
    out.update(main_path_grads())
    return out


def orth_err(U):
    U = U.double().cpu()
    eye = torch.eye(U.shape[-1], dtype=torch.float64)
    return float((U.transpose(-1, -2) @ U - eye).abs().max())


def timed(fn):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def report(name, label, U, ms, ranks, k, ref):
    for r in ranks:
        kept = r if k is None else min(k, r)
        ov = subspace_overlap(U[..., :kept].double().cpu(), ref[..., :kept])
        print(f"[svd] {name} {label} r={r}: max|UᵀU - I| {orth_err(U[..., :r]):.2e}, overlap "
              f"with f64 LAPACK {float(ov.min()):.8f}" + (f", {ms:.1f} ms" if ms else ""),
              flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("svd_accuracy: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, (G, k) in cases().items():
        ref = torch.linalg.svd(G.cpu().double(), full_matrices=False)[0]
        ranks = (32,) if G.shape[-2] == 512 else (128, 1024)
        for d in DRIVERS:
            try:
                U, ms = timed(lambda: torch.linalg.svd(G, full_matrices=False, driver=d)[0])
            except torch.linalg.LinAlgError as e:
                print(f"[svd] {name} card {d}: FAILED {str(e)[:100]}", flush=True)
                continue
            report(name, f"card {d}", U, ms, ranks, k, ref)
        for r in ranks:
            P, ms = timed(lambda: compute_projector(G, r))
            report(name, "card compute_projector", P, ms, (r,), k, ref)
        U = torch.linalg.svd(G.cpu(), full_matrices=False)[0]
        report(name, "CPU f32 LAPACK", U, None, ranks[:1], k, ref)


if __name__ == "__main__":
    main()
