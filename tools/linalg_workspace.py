#!/usr/bin/env python3
"""What does each of the refresh's linear-algebra calls allocate on the card
beyond its inputs and outputs?

    python3 tools/linalg_workspace.py [--out PATH]

The dry run (launch/dryrun.py) counts every tensor a step makes on the meta
device, but a CUDA library call also takes memory from PyTorch's caching
allocator that no tensor holds: cuSOLVER's column-major copy of the input
and its workspace, for one. For torch.linalg.svd (driver "gesvd", as
core/projector.py calls it), torch.linalg.qr and torch.linalg.eigh at the
shapes the refreshes of chip_smoke.py's phases give them (and a spread
around them, stacked and transposed, for the fit), this prints, per call,
the bytes allocated at its peak above what was live before it, less its
outputs (each rounded up to the allocator's 512 bytes): the hidden bytes
the dry run's rule for that call must add. Then cuSOLVER's own
gesvd buffer size (cusolverDnSgesvd_bufferSize, through ctypes) where the
library loads. One line of JSON per probe, and --out writes them all.
Needs a CUDA card; imports no JAX.
"""
import argparse
import ctypes
import glob
import json
import os

import torch

SVD_SHAPES = [(1, 512, 512), (1, 1024, 4096), (1, 4096, 1024), (1, 4096, 4096),
              (2, 4096, 4096), (1, 4096, 11008), (2, 4096, 11008), (1, 11008, 4096),
              (12, 768, 768), (12, 768, 3072), (24, 768, 1536), (1, 3072, 768),
              (64, 144, 8192), (2, 2048, 5632), (1, 1000, 520)]
QR_SHAPES = [(2, 4096, 128), (2, 11008, 128), (64, 5120, 144), (64, 8192, 144), (2, 4096, 1024),
             (12, 768, 128)]
EIGH_SHAPES = [(64, 144, 144), (2, 1024, 1024)]


def rounded(t) -> int:
    return -(-t.untyped_storage().nbytes() // 512) * 512


def probe(name, make, call):
    """Hidden bytes of call(*make()): the peak above the bytes live before
    the call, less its outputs."""
    args = make()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    outs = out if isinstance(out, (tuple, list)) else (out,)
    seen, out_bytes = set(), 0
    for t in outs:
        if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in seen:
            seen.add(t.untyped_storage().data_ptr())
            out_bytes += rounded(t)
    row = dict(op=name, shape=[list(a.shape) for a in args if isinstance(a, torch.Tensor)],
               strides=[list(a.stride()) for a in args if isinstance(a, torch.Tensor)],
               hidden=peak - before - out_bytes, out_bytes=out_bytes,
               after=torch.cuda.memory_allocated() - before - out_bytes)
    del out, outs, args
    torch.cuda.empty_cache()
    return row


def cusolver_gesvd_lwork():
    """cusolverDnSgesvd_bufferSize(m, n) through ctypes, or None where the
    library does not load."""
    paths = glob.glob(os.path.join(os.path.dirname(torch.__file__), "lib", "libcusolver.so*"))
    paths += glob.glob(os.path.join(os.path.dirname(os.path.dirname(torch.__file__)), "nvidia",
                                    "cusolver", "lib", "libcusolver.so*"))
    paths += ["libcusolver.so", "/usr/local/cuda/lib64/libcusolver.so"]
    for p in paths:
        try:
            lib = ctypes.CDLL(p)
        except OSError:
            continue
        handle = ctypes.c_void_p()
        if lib.cusolverDnCreate(ctypes.byref(handle)) != 0:
            continue

        def lwork(m, n):
            out = ctypes.c_int()
            err = lib.cusolverDnSgesvd_bufferSize(handle, m, n, ctypes.byref(out))
            return out.value if err == 0 else None

        return p, lwork
    return None, None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("linalg_workspace: no CUDA device is available")
    print(torch.cuda.get_device_name(0), flush=True)
    rows = []
    dev = "cuda"
    for L, m, n in SVD_SHAPES:
        for tr in (False, True):
            def make(L=L, m=m, n=n, tr=tr):
                a = torch.randn(L, n, m, device=dev) if tr else torch.randn(L, m, n, device=dev)
                return (a.transpose(-1, -2) if tr else a,)
            rows.append(probe("svd_gesvd", make, lambda a: torch.linalg.svd(
                a, full_matrices=False, driver="gesvd")))
            print(json.dumps(rows[-1]), flush=True)
    for L, m, n in QR_SHAPES:
        rows.append(probe("qr", lambda L=L, m=m, n=n: (torch.randn(L, m, n, device=dev),),
                          torch.linalg.qr))
        print(json.dumps(rows[-1]), flush=True)
    for L, m, n in EIGH_SHAPES:
        rows.append(probe("eigh", lambda L=L, m=m: (torch.eye(m, device=dev).expand(L, m, m)
                                                    .contiguous(),), torch.linalg.eigh))
        print(json.dumps(rows[-1]), flush=True)
    path, lwork = cusolver_gesvd_lwork()
    if lwork is not None:
        for _, m, n in SVD_SHAPES:
            for a, b in ((m, n), (n, m)):
                if a >= b:
                    rows.append(dict(op="cusolverDnSgesvd_bufferSize", m=a, n=b,
                                     lwork=lwork(a, b), lib=path))
                    print(json.dumps(rows[-1]), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
