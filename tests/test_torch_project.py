"""The port's tiled projections (B4, B5), the fp32 fused step's routing
predicate and RMSNorm (B6) against the JAX package on the same inputs: the
plain versions against the Pallas kernels in interpret mode, and the port's
copy of the reference's ``fits_vmem`` against the reference's. The composite
leaf step built on B4/B5 is tests/test_torch_composite.py's. The kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import galore_fused as jgf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import galore_fused as tk  # noqa: E402
from repro_torch.kernels import galore_project as tp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as tr  # noqa: E402
from test_torch_cuda import PROJECT_SHAPES, proj_inputs  # noqa: E402
from test_torch_quant import _assert_close  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

# ---------------------------------------------------------------------------
# 1. B4 / B5: the plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", PROJECT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transpose_g", [False, True])
def test_project_plain_matches_pallas_interpret(shape, dtype, transpose_g):
    """galore_project (the wrapper on CPU tensors: its plain version) ==
    repro.kernels.ops.galore_project in interpret mode, to tests/
    test_kernels.py's 1e-5·max; with `transpose_g` the port reads G stored
    transposed, as the right leaf's composite step hands it over."""
    P, G, _ = proj_inputs(shape)
    want = jops.galore_project(jnp.asarray(P), jnp.asarray(G).astype(dtype), use_pallas=True,
                               interpret=True)
    Gt = torch.from_numpy(G).to(getattr(torch, dtype))
    if transpose_g:
        Gt = Gt.transpose(-1, -2).contiguous()
    tp.galore_project.launches = 0
    got = tp.galore_project(torch.from_numpy(P), Gt, transpose_g=transpose_g)
    assert tp.galore_project.launches == 0  # the plain version ran
    assert got.dtype == torch.float32 and got.shape == want.shape
    _assert_close(got, want, f"{shape} {dtype} transpose_g {transpose_g}")


@pytest.mark.parametrize("shape", PROJECT_SHAPES)
@pytest.mark.parametrize("transpose_out", [False, True])
def test_project_back_plain_matches_pallas_interpret(shape, transpose_out):
    """galore_project_back on CPU tensors == the Pallas kernel in interpret
    mode (α = 0.25), to 1e-5·max; with `transpose_out` the port writes G̃
    transposed and contiguous."""
    P, _, N = proj_inputs(shape)
    want = np.asarray(jops.galore_project_back(jnp.asarray(P), jnp.asarray(N), 0.25,
                                               use_pallas=True, interpret=True))
    tp.galore_project_back.launches = 0
    got = tp.galore_project_back(torch.from_numpy(P), torch.from_numpy(N), 0.25,
                                 transpose_out=transpose_out)
    assert tp.galore_project_back.launches == 0
    if transpose_out:
        assert got.is_contiguous()
        got = got.transpose(-1, -2)
    assert got.shape == want.shape
    _assert_close(got, want, f"{shape} transpose_out {transpose_out}")


# ---------------------------------------------------------------------------
# 2. the routing predicate
# ---------------------------------------------------------------------------


def _leaf_sides(arch):
    """(kept, swept) of the GaLore leaves of a config: wq…wo (d, d); gate and
    up (d, d_ff) on the left, and down (d_ff, d) on the right, kept d too."""
    cfg = get_config(arch)
    return [(cfg.d_model, cfg.d_model), (cfg.d_model, cfg.d_ff)]


FITS_GRID = sorted({(kept, r, swept, itemsize)
                    for arch in ("llama_1b", "llama_7b") for kept, swept in _leaf_sides(arch)
                    for r in (128, 256, 512, 1024) for itemsize in (2, 4)}
                   | {(2048, 1024, 96, 4), (2048, 1024, 96, 2), (1000, 96, 520, 4),
                      (64, 16, 48, 4), (4096, 384, 4096, 2), (3072, 512, 128, 4)})


def test_fits_vmem_matches_reference():
    """The port's copy of the reference's dispatch predicate gives the
    reference's answer on every leaf shape of llama_1b and llama_7b at r ∈
    {128, 256, 512, 1024}, G f32 and bf16, and on the tests' shapes."""
    got = {s: tk.fits_vmem(*s) for s in FITS_GRID}
    want = {s: jgf.fits_vmem(*s) for s in FITS_GRID}
    assert got == want
    # the grid crosses the boundary: llama_7b fits at r ≤ 256, not at r ≥ 512
    assert got[(4096, 256, 11008, 2)] and not got[(4096, 512, 4096, 2)]
    assert got[(2048, 512, 5461, 2)] and not got[(2048, 1024, 2048, 2)]


# ---------------------------------------------------------------------------
# 4. B6 RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 64), (3, 7, 128), (1, 1024), (33, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_interpret(shape, dtype):
    """ops.rmsnorm on CPU tensors (its plain version) == the Pallas kernel in
    interpret mode, at tests/test_kernels.py::test_rmsnorm_kernel's shapes
    and tolerances (1e-5 f32, 2e-2 bf16), in x's dtype."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape, np.float32)
    scale = rng.standard_normal(shape[-1:], np.float32) + np.float32(1.0)
    want = jops.rmsnorm(jnp.asarray(x).astype(dtype), jnp.asarray(scale), use_pallas=True,
                        interpret=True)
    tr.rmsnorm.launches = 0
    got = ops.rmsnorm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(scale))
    assert tr.rmsnorm.launches == 0
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
