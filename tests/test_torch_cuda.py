"""The Hopper kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on the machine with the card:
    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
Every test carries the ``cuda`` marker and skips, with its reason, where
there is no CUDA device (the kernels have no CPU mode)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import galore_fused as tk  # noqa: E402

SHAPES = [
    (64, 16, 48),       # tiny, non-tile-aligned
    (1000, 96, 520),    # ragged everything
    (256, 128, 512),    # aligned
    (3, 72, 16, 130),   # stacked, ragged n
    (2, 3, 40, 8, 96),  # stacked experts (L, E)
]


def fused_inputs(shape, side, seed=13):
    """numpy P, G, M, V for one (lead…, m, r, n) shape at count 7.

    P has orthonormal columns, as every GaLore projector does, and M/V are
    what six earlier Adam steps on compact gradients of R's scale leave, so
    N̂ is not sign(R). Moments drawn independently (tests/test_kernels.py::
    _fused_inputs: a tiny V beside a non-zero M, which no Adam run produces)
    make N̂ so sensitive to R that two f32 summation orders differ by more
    than 1e-5·max."""
    rng = np.random.default_rng(seed)
    lead, (m, r, n) = tuple(shape[:-3]), shape[-3:]
    kept, mv = ((m, r), (r, n)) if side == "left" else ((n, r), (m, r))
    P = np.linalg.qr(rng.standard_normal(lead + kept))[0].astype(np.float32)
    G = rng.standard_normal(lead + (m, n), np.float32)
    M = np.zeros(lead + mv, np.float32)
    V = np.zeros(lead + mv, np.float32)
    for _ in range(6):
        R = rng.standard_normal(lead + mv, np.float32)
        M = np.float32(0.9) * M + np.float32(0.1) * R
        V = np.float32(0.999) * V + np.float32(0.001) * R * R
    return P, G, M, V


def assert_close(got, want, name):
    """|got - want| ≤ 1e-5·max|want| + 1e-5·|want| (tests/test_kernels.py's bar)."""
    got = got.detach().cpu().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(), err_msg=name)


def _cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(shape, side, dtype):
    dev = _cuda_device()
    P, G, M, V = (torch.from_numpy(a).to(dev) for a in fused_inputs(shape, side))
    G = G.to(getattr(torch, dtype))
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    tfn = tk.galore_fused_adam_step if side == "left" else tk.galore_fused_adam_step_right
    plain = (tk.galore_fused_adam_step_plain if side == "left"
             else tk.galore_fused_adam_step_right_plain)
    want = plain(P, G, M, V, count, alpha=0.25)
    before = tfn.launches
    M2, V2 = M.clone(), V.clone()
    got = tfn(P, G, M2, V2, count, alpha=0.25)
    torch.cuda.synchronize()
    assert tfn.launches == before + 1
    assert got[1] is M2 and got[2] is V2  # moments are updated in place
    for name, a, b in zip(["update", "m", "v"], got, want):
        assert_close(a, b.cpu().numpy(), f"{side} {shape} {dtype} {name}")


@pytest.mark.cuda
def test_cuda_wrapper_rejects_wrong_dtype():
    dev = _cuda_device()
    P, G, M, V = (torch.from_numpy(a).to(dev) for a in fused_inputs((64, 16, 48), "left"))
    count = torch.tensor(1, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        tk.galore_fused_adam_step(P, G.half(), M, V, count)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        tk.galore_fused_adam_step(P, G, M.cpu(), V, count)
