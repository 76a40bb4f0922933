"""Projector computation for GaLore: the top-r singular subspace of the
gradient (port of repro/core/projector.py), and the projector's persistent
storage forms (fp32, bf16, packed int4).

Three methods, as the reference's:
  svd           — exact ``torch.linalg.svd``; the paper's method.
  randomized    — Halko range finder: an (n, rank + 8) Gaussian sketch,
                  ``power_iters`` QR-reorthonormalised subspace iterations,
                  QR, then the small (s × n) SVD truncates to the top rank.
  newton_schulz — the same oversampled range finder orthonormalised by 22
                  Denman–Beavers iterations on the r × r Gram (matmuls only),
                  truncated by an ``eigh`` of the s × s Gram.
The reference's mesh constraints (``_constrain``) have no counterpart on one
card and are dropped.

The sketch is one (n, s) f32 Gaussian shared by every stacked element, as
the reference's vmap shares one key: passed in by the caller (a test hands
JAX's across), or drawn on the CPU from a ``torch.Generator`` —
``sketch_generator(key, step)`` derives one from a galore state's uint32[2]
key and the step, the analogue of ``fold_in(key, step)``. torch cannot
replay JAX's threefry streams, so the two packages draw different sketches
from the same key.

``torch.linalg.svd`` and ``jnp.linalg.svd`` may choose different column
signs. GaLore's update αP·N̂(PᵀG) does not change when a column of P flips,
so callers compare updates, losses and ``subspace_overlap``, never P entry
by entry.
"""
from __future__ import annotations

import hashlib

import torch

from repro_torch.quant import codec

_DB_ITERS = 22  # Denman–Beavers iterations for the r×r inverse sqrt
_DB_EPS = 1e-7  # relative Tikhonov floor on the Gram spectrum
_OVERSAMPLE = 8  # extra range-finder columns (Halko et al. 2011, §4.2)
METHODS = ("svd", "randomized", "newton_schulz")


def prng_key(seed: int) -> torch.Tensor:
    """The reference's ``jax.random.PRNGKey(seed)`` as a uint32[2] CPU tensor
    (threefry's [0, seed], 64-bit mode off)."""
    return torch.tensor([0, seed & 0xFFFFFFFF], dtype=torch.uint32)


def sketch_generator(key=None, step: int = 0) -> torch.Generator:
    """A CPU generator seeded from (key, step): the torch analogue of
    ``fold_in(key, step)``. key None is the reference's default PRNGKey(0)."""
    words = [0, 0] if key is None else [int(x) for x in key.tolist()]
    digest = hashlib.sha256(repr((*words, int(step))).encode()).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest[:8], "little"))


def sketch_width(rank: int, m: int, n: int) -> int:
    return min(rank + _OVERSAMPLE, m, n)


def _svd_u(G32, rank):
    """The top-`rank` left singular vectors of G32 (..., m, n), orthonormal.

    On the CPU, LAPACK (no driver choice), as the reference computes it. On
    CUDA, cuSOLVER's QR-based gesvd, its kept columns re-orthonormalised by
    a Householder QR (same span; columns keep their signs): the default
    driver (gesvdj) returns a U 1.6e-3–2.4e-3 off orthonormal at llama_7b
    leaves and gesvd alone up to 1.6e-4 (a tall leaf), while gesvda,
    orthonormal and 4–8× faster, fails to converge on a rank-deficient G —
    which a batch of fewer tokens than a leaf's width gives in f32."""
    if not G32.is_cuda:
        return torch.linalg.svd(G32, full_matrices=False)[0][..., :rank]
    U = torch.linalg.svd(G32, full_matrices=False, driver="gesvd")[0][..., :rank]
    Q, R = torch.linalg.qr(U)
    return Q * torch.sign(torch.diagonal(R, dim1=-2, dim2=-1)).unsqueeze(-2)


def _qr_q(Y):
    return torch.linalg.qr(Y)[0]


def _randomized_projector(G32, rank, omega, power_iters):
    """Oversampled range finder + exact truncation (Halko Alg. 5.1),
    re-orthonormalised by QR after every half step."""
    s = omega.shape[-1]
    Y = G32 @ omega
    Gt = G32.transpose(-1, -2)
    for _ in range(power_iters):
        Y = G32 @ _qr_q(Gt @ _qr_q(Y))
    Q = _qr_q(Y)  # (..., m, s)
    if s == rank:
        return Q
    return Q @ _svd_u(Q.transpose(-1, -2) @ G32, rank)


def _gram_orthonormalize(Y):
    """Y (..., m, r) -> orthonormal columns by matmuls only: Y·(YᵀY)^-1/2,
    the inverse square root by Denman–Beavers on the trace-normalised Gram."""
    r = Y.shape[-1]
    eye = torch.eye(r, dtype=torch.float32, device=Y.device)
    A = Y.transpose(-1, -2) @ Y
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None] + 1e-30
    Yk = A / tr + _DB_EPS * eye
    Zk = eye.expand(Yk.shape)
    for _ in range(_DB_ITERS):
        M = 1.5 * eye - 0.5 * (Zk @ Yk)
        Yk = Yk @ M
        Zk = M @ Zk
    return (Y @ Zk) * torch.rsqrt(tr)


def _ns_projector(G32, rank, omega, power_iters):
    s = omega.shape[-1]
    Gt = G32.transpose(-1, -2)
    Y = G32 @ omega
    for _ in range(power_iters):
        Y = G32 @ _gram_orthonormalize(Gt @ _gram_orthonormalize(Y))
    Q = _gram_orthonormalize(Y)  # (..., m, s)
    if s == rank:
        return Q
    # the s × s Gram of QᵀG carries G's squared spectrum restricted to
    # range(Q): its top-rank eigenvectors rotate Q onto the top subspace
    B = Q.transpose(-1, -2) @ G32
    _, vecs = torch.linalg.eigh(B @ B.transpose(-1, -2))  # ascending
    return Q @ vecs[..., -rank:].flip(-1)


def compute_projector(G: torch.Tensor, rank: int, *, method: str = "svd", sketch=None,
                      generator: torch.Generator | None = None,
                      power_iters: int = 2) -> torch.Tensor:
    """G (..., m, n) -> P (..., m, rank) f32 spanning the top-`rank` left
    singular subspace; leading (stacked-layer) dims are batched.

    The randomized methods take `sketch` ((n, s) f32, s = sketch_width) or
    draw it from `generator` (default: sketch_generator(), the reference's
    PRNGKey(0))."""
    G32 = G.float()
    if method == "svd":
        return _svd_u(G32, rank).contiguous()
    if method not in METHODS:
        raise ValueError(f"unknown projector method {method!r}")
    m, n = G.shape[-2:]
    if sketch is None:
        gen = generator if generator is not None else sketch_generator()
        sketch = torch.randn((n, sketch_width(rank, m, n)), generator=gen,
                             dtype=torch.float32)
    omega = sketch.to(device=G.device, dtype=torch.float32)
    fn = _randomized_projector if method == "randomized" else _ns_projector
    return fn(G32, rank, omega, power_iters).contiguous()


# Projector storage. The persistent copy of P between refreshes is fp32, bf16,
# or packed INT4 in the axis-blocked layout the fused kernel reads directly
# (quant/codec.py::quantize4_axis); consumers read it through
# `read_projector`, so an f32 P exists only transiently.


def store_projector(P: torch.Tensor, mode: str = "fp32"):
    """f32 projector -> its persistent storage form (tensor or int4 qstate)."""
    if mode == "fp32":
        return P.to(torch.float32)
    if mode == "bf16":
        return P.to(torch.bfloat16)
    if mode == "int4":
        return codec.quant4_axis_state(P)
    raise ValueError(f"unknown projector storage mode {mode!r}")


def read_projector(stored, shape=None) -> torch.Tensor:
    """Dequant-on-read: storage form -> f32 P (`shape` required for int4).
    Reads both int4 layouts: the axis-blocked one `store_projector` writes
    (codes and scales of equal rank) and the reference's legacy flat one
    (2-D codes, 1-D scales) that older checkpoints hold."""
    if codec.is_qstate(stored):
        if shape is None:
            raise ValueError("an int4 projector read needs the logical shape")
        if codec.is_axis4_qstate(stored):
            return codec.dequant4_axis_state(stored, shape)
        return codec.dequant4_state(stored, shape)
    return stored.to(torch.float32)


def init_projector_state(shape, mode: str = "fp32", device=None):
    """Zeros in the requested storage form (int4 zeros round-trip exactly)."""
    return store_projector(torch.zeros(shape, dtype=torch.float32, device=device), mode)


def subspace_overlap(P: torch.Tensor, P_ref: torch.Tensor) -> torch.Tensor:
    """Mean squared principal cosine between two column subspaces (1.0 = same),
    per leading batch element."""
    M = P_ref.float().transpose(-1, -2) @ P.float()
    s = torch.linalg.svdvals(M)
    return s.square().mean(dim=-1)
