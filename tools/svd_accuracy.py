#!/usr/bin/env python3
"""How accurate is the GaLore refresh's SVD on the card?

    python3 tools/svd_accuracy.py

core/projector.py::compute_projector keeps U[:, :r] of torch.linalg.svd.
For each cuSOLVER driver (the default, gesvd, gesvdj, gesvda) this prints,
at a 512 x 512 gradient with a planted rank-32 part (singular values 10 …
48.75 over noise of ≈ 0.2) and at Gaussian llama_7b leaves (4096 x 4096 and
4096 x 11008, r = 128), in f32 on the card:
  * max |UᵀU − I| of the kept columns (0 for an orthonormal P), and
  * their subspace overlap (core/projector.py::subspace_overlap) with the
    top-r left singular subspace LAPACK computes in f64 on the CPU;
then the same for LAPACK in f32 on the CPU, and each driver's time (the
median of 3 calls after one warm-up, CUDA events). Needs a CUDA card;
imports no JAX.
"""
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

from repro_torch.core.projector import subspace_overlap  # noqa: E402

DRIVERS = (None, "gesvd", "gesvdj", "gesvda")


def cases(seed=0):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((512, 32)))[0]
    V = np.linalg.qr(rng.standard_normal((512, 32)))[0]
    planted = (U * (10.0 * (1 + np.arange(32) / 8))) @ V.T
    planted += 0.1 * rng.standard_normal((512, 512)) / np.sqrt(512)
    return {"planted 512x512 r32": (planted.astype(np.float32), 32),
            "gaussian 4096x4096 r128": (rng.standard_normal((4096, 4096), np.float32), 128),
            "gaussian 4096x11008 r128": (rng.standard_normal((4096, 11008), np.float32), 128)}


def orth_err(U):
    U = U.double().cpu()
    return float((U.T @ U - torch.eye(U.shape[1], dtype=torch.float64)).abs().max())


def svd_ms(G, driver):
    times = []
    for i in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.linalg.svd(G, full_matrices=False, driver=driver)
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("svd_accuracy: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, (G, r) in cases().items():
        Gc = torch.from_numpy(G)
        ref = torch.linalg.svd(Gc.double(), full_matrices=False)[0][:, :r]
        Gg = Gc.cuda()
        for driver in DRIVERS:
            U = torch.linalg.svd(Gg, full_matrices=False, driver=driver)[0][:, :r]
            print(f"[svd] {name} card driver={driver or 'default'}: max|UᵀU - I| "
                  f"{orth_err(U):.2e}, overlap with f64 LAPACK "
                  f"{float(subspace_overlap(U.double().cpu(), ref)):.8f}, "
                  f"{svd_ms(Gg, driver):.1f} ms", flush=True)
        U = torch.linalg.svd(Gc, full_matrices=False)[0][:, :r]
        print(f"[svd] {name} CPU f32 LAPACK: max|UᵀU - I| {orth_err(U):.2e}, overlap with f64 "
              f"LAPACK {float(subspace_overlap(U.double(), ref)):.8f}", flush=True)


if __name__ == "__main__":
    main()
