"""The Hopper kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on the machine with the card:
    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
Every test carries the ``cuda`` marker and skips, with its reason, where
there is no CUDA device (the kernels have no CPU mode)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import adam8bit_update as a8  # noqa: E402
from repro_torch.kernels import galore_fused as tk  # noqa: E402
from repro_torch.kernels import galore_project as tp  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.quant import codec  # noqa: E402

SHAPES = [
    (64, 16, 48),       # tiny, non-tile-aligned
    (1000, 96, 520),    # ragged everything
    (256, 128, 512),    # aligned
    (3, 72, 16, 130),   # stacked, ragged n
    (2, 3, 40, 8, 96),  # stacked experts (L, E)
]


@functools.lru_cache(maxsize=None)
def _fused_inputs(shape, side, seed):
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


def fused_inputs(shape, side, seed=13):
    """_fused_inputs, computed once a (shape, side, seed) and copied to each
    caller (callers update moments in place)."""
    return tuple(a.copy() for a in _fused_inputs(tuple(shape), side, seed))


# (lead..., m, r, n) of the tiled projection checks: ragged everything, a
# stacked (L = 2) leaf with ragged n, stacked experts (L, E), and a leaf of
# several 128 x 128 output tiles each way with a K of many 16-deep steps
PROJECT_SHAPES = [(1000, 96, 520), (2, 300, 64, 130), (2, 3, 40, 8, 96), (2, 520, 264, 1000)]


@functools.lru_cache(maxsize=None)
def _proj_inputs(shape, seed):
    """numpy P (..., m, r) with orthonormal columns, G (..., m, n) and
    N (..., r, n) for one (lead..., m, r, n) shape."""
    rng = np.random.default_rng(seed)
    lead, (m, r, n) = tuple(shape[:-3]), shape[-3:]
    P = np.linalg.qr(rng.standard_normal(lead + (m, r)))[0].astype(np.float32)
    return (P, rng.standard_normal(lead + (m, n), np.float32),
            rng.standard_normal(lead + (r, n), np.float32))


def proj_inputs(shape, seed=3):
    """_proj_inputs, computed once a (shape, seed) and copied to each caller."""
    return tuple(a.copy() for a in _proj_inputs(tuple(shape), seed))


# (shape, side) of the int8-moment kernel checks: ragged n (130, 520), a
# stacked leaf, a ragged rank (96), and a right leaf with ragged m
ADAM8_CASES = [
    ((72, 16, 130), "left"),
    ((3, 72, 16, 130), "left"),
    ((1000, 96, 520), "left"),
    ((130, 16, 72), "right"),
]


@functools.lru_cache(maxsize=None)
def adam8_inputs(shape, side, seed=17):
    """numpy P (orthonormal columns), G and the int8 moments (Mq, Ms, Vq, Vs)
    of step 7: the codes and scales that six earlier steps of the plain 8-bit
    version leave, on gradients of the same scale (ROADMAP C.3). Cached:
    callers copy before they update anything in place."""
    rng = np.random.default_rng(seed)
    lead, (m, r, n) = tuple(shape[:-3]), shape[-3:]
    left = side == "left"
    kept, mv = ((m, r), (r, n)) if left else ((n, r), (m, r))
    P = np.linalg.qr(rng.standard_normal(lead + kept))[0].astype(np.float32)
    ax = -1 if left else -2
    zeros = torch.zeros(lead + mv)
    moments = (*codec.quantize_axis(zeros, axis=ax, signed=True),
               *codec.quantize_axis(zeros, axis=ax, signed=False))
    plain = ref.galore_fused_adam8_step if left else ref.galore_fused_adam8_step_right
    for t in range(1, 7):
        G = torch.from_numpy(rng.standard_normal(lead + (m, n), np.float32))
        moments = plain(torch.from_numpy(P), G, *moments, torch.tensor(t, dtype=torch.int32))[1:]
    G = rng.standard_normal(lead + (m, n), np.float32)
    return P, G, tuple(t.numpy() for t in moments)


# leaf sizes of the flat 8-bit Adam checks: one block, a ragged tail, a
# ragged 1000 x 520 leaf, and 33 whole blocks; single elements, a block's
# edges, a lane's 8 elements cut by numel (8191), the model's norm leaves
# (4096,) and (2, 4096) and a (2, 4096, 4096) attention leaf
FLAT_NUMELS = [256, 700, 1000 * 520, 33 * 256, 1, 7, 255, 257, 8191, 4096, 2 * 4096,
               2 * 4096 * 4096]


@functools.lru_cache(maxsize=None)
def flat_inputs(numel, seed=23):
    """numpy g (numel,) and the flat int8 moments (Mq, Ms, Vq, Vs) of step 7:
    what six earlier steps of the plain 8-bit Adam leave on gradients of the
    same scale. Cached: callers copy before they update anything in place."""
    rng = np.random.default_rng(seed)
    zeros = torch.zeros(numel)
    moments = (*codec.quantize(zeros, signed=True), *codec.quantize(zeros, signed=False))
    for t in range(1, 7):
        g = torch.from_numpy(rng.standard_normal(numel, np.float32) * np.float32(0.01))
        moments = a8.adam8bit_update_plain(g, *moments, torch.tensor(t, dtype=torch.int32))[1:]
    g = rng.standard_normal(numel, np.float32) * np.float32(0.01)
    return g, tuple(t.numpy() for t in moments)


def assert_codes_close(got, want, name):
    """Codes at most one apart (the reference suite's bar: the contractions'
    summation order may move a value across a midpoint)."""
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got).astype(np.int32)
    want = np.asarray(want.cpu() if isinstance(want, torch.Tensor) else want).astype(np.int32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert int(np.abs(got - want).max()) <= 1, name


def assert_close(got, want, name):
    """|got - want| ≤ 1e-5·max|want| + 1e-5·|want| (tests/test_kernels.py's bar)."""
    got = got.detach().cpu().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(), err_msg=name)


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.exp2(e - 7)


def assert_weight_close(got, want, w0, name, tol, ulps=0):
    """An updated weight against its reference. f32 W: the applied change
    W' - W (in f64) within tol·max|want - W| plus `ulps` f32 ulps of W'.
    bf16 W: at most one bf16 ulp apart (the two round one f32 value each);
    with `ulps` (a kernel against its plain version, whose G̃ sums in another
    order) also tol·max|want - W|, which a W' near 0 needs: there the f32 sum
    cancels, and a G̃ within its tolerance moves the tiny W' by several of its
    tiny ulps."""
    def f64(t):
        return np.asarray(t.detach().cpu().double().numpy() if isinstance(t, torch.Tensor) else t,
                          np.float64)
    got, want, w0_ = f64(got), f64(want), f64(w0)
    change = want - w0_
    if w0.dtype == torch.bfloat16:
        slack = tol * np.abs(change).max() if ulps else 0.0
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + slack), name
        return
    atol = tol * np.abs(change).max() + ulps * np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs((got - w0_) - change) <= atol), (
        name, float(np.abs((got - w0_) - change).max()), float(tol * np.abs(change).max()))


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


def _adam8_on(dev, shape, side, p_int4):
    P, G, moments = adam8_inputs(shape, side)
    P = torch.from_numpy(P)
    if p_int4:
        P = codec.quant4_axis_state(P)
    to = lambda t: t.to(dev)  # noqa: E731
    P = {k: to(v) for k, v in P.items()} if p_int4 else to(P)
    return P, to(torch.from_numpy(G)), [to(torch.from_numpy(t)) for t in moments]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,side", ADAM8_CASES)
@pytest.mark.parametrize("p_int4", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
def test_cuda_adam8_kernel_matches_plain(shape, side, p_int4, stochastic):
    dev = _cuda_device()
    P, G, moments = _adam8_on(dev, shape, side, p_int4)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    right = side == "right"
    tfn = tk.galore_fused_adam8_step_right if right else tk.galore_fused_adam8_step
    plain = tk.galore_fused_adam8_step_right_plain if right else tk.galore_fused_adam8_step_plain
    want = plain(P, G, *moments, count, alpha=0.25, stochastic=stochastic)
    before = tfn.launches
    mine = [t.clone() for t in moments]
    got = tfn(P, G, *mine, count, alpha=0.25, stochastic=stochastic)
    torch.cuda.synchronize()
    assert tfn.launches == before + 1
    assert all(a is b for a, b in zip(got[1:], mine))  # codes and scales updated in place
    tag = f"{side} {shape} int4 P {p_int4} stochastic {stochastic}"
    for name, a, b in zip(["update", "mq", "ms", "vq", "vs"], got, want):
        if b.dtype == torch.uint8:
            assert_codes_close(a, b, f"{tag} {name}")
        else:
            assert_close(a, b.cpu().numpy(), f"{tag} {name}")


# (shape, side) of the rank-block checks (GaLore-ZeRO at n_dp 2): a stacked
# leaf with ragged n, a right leaf with ragged m, one 128-row rank chunk in
# blocks of 64, and two chunks (r = 256) in blocks of 128
SR_BLOCK_CASES = [((3, 72, 16, 130), "left"), ((130, 16, 72), "right"),
                  ((2, 512, 128, 1000), "left"), ((1, 300, 256, 520), "right")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,side", SR_BLOCK_CASES)
@pytest.mark.parametrize("apply", [False, True])
@pytest.mark.parametrize("p_int4", [False, True])
def test_cuda_adam8_rank_block_with_origin_is_the_full_launchs_slice(shape, side, apply, p_int4):
    """ROADMAP C.27 on the card: the int8 kernel with stochastic rounding,
    launched on each of two rank blocks of P and the moments with the
    block's origin (sr_off, sr_full), writes exactly the slice of the
    full-leaf launch's codes and scales (emit and apply forms, f32 and int4
    P); the blocks' G̃ sum to the full launch's within 1e-5·max."""
    dev = _cuda_device()
    P, G, moments = _adam8_on(dev, shape, side, p_int4)
    r, right = shape[-2], side == "right"
    rb, dim = r // 2, -1 if right else -2
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    if apply:
        fn = tk.galore_fused_adam8_apply_step_right if right else tk.galore_fused_adam8_apply_step
    else:
        fn = tk.galore_fused_adam8_step_right if right else tk.galore_fused_adam8_step

    def launch(Pa, mom, origin=None):
        mom = [t.clone() for t in mom]
        before = fn.launches
        if apply:
            W = torch.zeros(G.shape, dtype=torch.float32, device=dev)
            fn(Pa, G, W, *mom, count, eta=torch.tensor([-1e-2], device=dev), alpha=0.25,
               stochastic=True, origin=origin)
            out = None
        else:
            out = fn(Pa, G, *mom, count, alpha=0.25, stochastic=True, origin=origin)[0]
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        return out, mom

    full_out, full = launch(P, moments)
    total = None
    for k in range(2):
        cut = lambda t, d=dim: t.narrow(d, k * rb, rb).contiguous()  # noqa: E731
        Pk = {key: cut(v, -1) for key, v in P.items()} if p_int4 else cut(P, -1)
        out, got = launch(Pk, [cut(t) for t in moments], (k * rb, r))
        for name, a, b in zip(("mq", "ms", "vq", "vs"), got, full):
            assert torch.equal(a, cut(b)), f"{side} {shape} block {k} {name}"
        if out is not None:
            total = out if total is None else total + out
    if not apply:
        assert_close(total, full_out.cpu().numpy(), f"{side} {shape} G̃ of the blocks")


@pytest.mark.cuda
def test_cuda_adam8_never_runs_the_plain_version(monkeypatch):
    dev = _cuda_device()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tk, "galore_fused_adam8_step_plain", refuse)
    monkeypatch.setattr(tk, "galore_fused_adam8_step_right_plain", refuse)
    for shape, side in ADAM8_CASES[::3]:
        P, G, moments = _adam8_on(dev, shape, side, True)
        fn = tk.galore_fused_adam8_step_right if side == "right" else tk.galore_fused_adam8_step
        fn(P, G, *moments, torch.tensor(1, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_adam8_wrapper_rejects_wrong_inputs():
    dev = _cuda_device()
    P, G, (mq, ms, vq, vs) = _adam8_on(dev, (72, 16, 130), "left", False)
    count = torch.tensor(1, dtype=torch.int32, device=dev)
    fn = tk.galore_fused_adam8_step
    with pytest.raises(TypeError):  # f32 codes
        fn(P, G, mq.float(), ms, vq, vs, count)
    with pytest.raises(TypeError):  # an int64 count
        fn(P, G, mq, ms, vq, vs, count.long())
    with pytest.raises(ValueError):  # scales blocked along the wrong axis
        fn(P, G, mq, ms.t().contiguous(), vq, vs, count)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        fn(P, G, mq, ms, vq.cpu(), vs, count)
    with pytest.raises(ValueError):  # an int4 P of another rank than the moments
        fn(codec.quant4_axis_state(P[:, :8]), G, mq, ms, vq, vs, count)


# ---------------------------------------------------------------------------
# the weight-apply forms
# ---------------------------------------------------------------------------

APPLY_KW = dict(alpha=0.25, wd=0.01)
# the int8 cases, and r = 200: two rank chunks, so the kernel keeps N̂ in a
# scratch and applies W in a last pass
ADAM8_APPLY_CASES = ADAM8_CASES + [((300, 200, 520), "left"), ((520, 200, 300), "right")]


def _w_on(dev, shape, dtype, seed=5):
    lead, (m, _, n) = tuple(shape[:-3]), shape[-3:]
    w = np.random.default_rng(seed).standard_normal(lead + (m, n)).astype(np.float32) * 0.02
    return torch.from_numpy(w).to(dev).to(getattr(torch, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_cuda_apply_kernel_matches_plain(shape, side, w_dtype):
    dev = _cuda_device()
    P, G, M, V = (torch.from_numpy(a).to(dev) for a in fused_inputs(shape, side))
    G = G.to(getattr(torch, w_dtype))
    W = _w_on(dev, shape, w_dtype)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    eta = torch.tensor(-1e-3, device=dev)
    right = side == "right"
    tfn = tk.galore_fused_adam_apply_step_right if right else tk.galore_fused_adam_apply_step
    plain = (tk.galore_fused_adam_apply_step_right_plain if right
             else tk.galore_fused_adam_apply_step_plain)
    want = plain(P, G, W, M, V, count, eta=eta, **APPLY_KW)
    before, w0, ptr = tfn.launches, W.clone(), W.data_ptr()
    M2, V2 = M.clone(), V.clone()
    got = tfn(P, G, W, M2, V2, count, eta=eta, **APPLY_KW)
    torch.cuda.synchronize()
    assert tfn.launches == before + 1
    assert got[0] is W and W.data_ptr() == ptr and got[1] is M2 and got[2] is V2
    tag = f"{side} {shape} W {w_dtype}"
    assert_weight_close(W, want[0], w0, f"{tag} W", tol=1e-5, ulps=2)
    assert_close(M2, want[1].cpu().numpy(), f"{tag} m")
    assert_close(V2, want[2].cpu().numpy(), f"{tag} v")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,side", ADAM8_APPLY_CASES)
@pytest.mark.parametrize("p_int4", [False, True])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_cuda_adam8_apply_kernel_matches_plain(shape, side, p_int4, w_dtype):
    dev = _cuda_device()
    P, G, moments = _adam8_on(dev, shape, side, p_int4)
    G = G.to(getattr(torch, w_dtype))
    W = _w_on(dev, shape, w_dtype)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    eta = torch.tensor(-1e-3, device=dev)
    right = side == "right"
    tfn = tk.galore_fused_adam8_apply_step_right if right else tk.galore_fused_adam8_apply_step
    plain = (tk.galore_fused_adam8_apply_step_right_plain if right
             else tk.galore_fused_adam8_apply_step_plain)
    want = plain(P, G, W, *moments, count, eta=eta, **APPLY_KW)
    before, w0, ptr = tfn.launches, W.clone(), W.data_ptr()
    mine = [t.clone() for t in moments]
    got = tfn(P, G, W, *mine, count, eta=eta, **APPLY_KW)
    torch.cuda.synchronize()
    assert tfn.launches == before + 1
    assert got[0] is W and W.data_ptr() == ptr and all(a is b for a, b in zip(got[1:], mine))
    tag = f"{side} {shape} int4 P {p_int4} W {w_dtype}"
    assert_weight_close(W, want[0], w0, f"{tag} W", tol=1e-5, ulps=2)
    for name, a, b in zip(["mq", "ms", "vq", "vs"], got[1:], want[1:]):
        if b.dtype == torch.uint8:
            assert_codes_close(a, b, f"{tag} {name}")
        else:
            assert_close(a, b.cpu().numpy(), f"{tag} {name}")


@pytest.mark.cuda
def test_cuda_apply_never_runs_the_plain_version(monkeypatch):
    dev = _cuda_device()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("galore_fused_adam_apply_step_plain", "galore_fused_adam_apply_step_right_plain",
                 "galore_fused_adam8_apply_step_plain",
                 "galore_fused_adam8_apply_step_right_plain"):
        monkeypatch.setattr(tk, name, refuse)
    count = torch.tensor(1, dtype=torch.int32, device=dev)
    eta = torch.tensor(-1e-3, device=dev)
    for shape, side in (((72, 16, 130), "left"), ((130, 16, 72), "right")):
        right = side == "right"
        P, G, M, V = (torch.from_numpy(a).to(dev) for a in fused_inputs(shape, side))
        fn = tk.galore_fused_adam_apply_step_right if right else tk.galore_fused_adam_apply_step
        fn(P, G, _w_on(dev, shape, "float32"), M, V, count, eta=eta)
        P, G, moments = _adam8_on(dev, shape, side, True)
        fn = tk.galore_fused_adam8_apply_step_right if right else tk.galore_fused_adam8_apply_step
        fn(P, G, _w_on(dev, shape, "bfloat16"), *moments, count, eta=eta)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_cuda_apply_wrappers_reject_wrong_weights(quant):
    dev = _cuda_device()
    shape = (72, 16, 130)
    count = torch.tensor(1, dtype=torch.int32, device=dev)
    eta = torch.tensor(-1e-3, device=dev)
    if quant:
        P, G, moments = _adam8_on(dev, shape, "left", False)
        fn = tk.galore_fused_adam8_apply_step
    else:
        P, G, M, V = (torch.from_numpy(a).to(dev) for a in fused_inputs(shape, "left"))
        moments = [M, V]
        fn = tk.galore_fused_adam_apply_step
    W = _w_on(dev, shape, "float32")
    before = fn.launches
    with pytest.raises(ValueError):  # a CPU weight among CUDA tensors
        fn(P, G, W.cpu(), *moments, count, eta=eta)
    with pytest.raises(ValueError):  # a non-contiguous weight
        fn(P, G, W.t().contiguous().t(), *moments, count, eta=eta)
    with pytest.raises(TypeError):  # an f16 weight
        fn(P, G, W.half(), *moments, count, eta=eta)
    with pytest.raises(ValueError):  # η on the host would sync every step
        fn(P, G, W, *moments, count, eta=eta.cpu())
    with pytest.raises(ValueError):  # a weight of another shape than G
        fn(P, G, W[:, :64].contiguous(), *moments, count, eta=eta)
    assert fn.launches == before


# ---------------------------------------------------------------------------
# the flat 8-bit Adam kernel (the 8-bit Adam baseline)
# ---------------------------------------------------------------------------


# the plain flat step as the input maker runs it, bound here so that a test
# that forbids the plain version on CUDA tensors can still make its inputs
_plain_flat_step = a8.adam8bit_update_plain


def _flat_on(dev, numel, seed=23):
    """flat_inputs made on the card: g (numel,) f32 drawn with numpy, and the
    moments six plain steps leave there (the CPU would take minutes at the
    largest leaf)."""
    rng = np.random.default_rng(seed)
    draw = lambda: torch.from_numpy(  # noqa: E731
        rng.standard_normal(numel, np.float32) * np.float32(0.01)).to(dev)
    zeros = torch.zeros(numel, device=dev)
    moments = (*codec.quantize(zeros, signed=True), *codec.quantize(zeros, signed=False))
    for t in range(1, 7):
        count = torch.tensor(t, dtype=torch.int32, device=dev)
        moments = _plain_flat_step(draw(), *moments, count)[1:]
    return draw(), list(moments)


def _offset(t, by=1):
    """t's values `by` elements into a larger buffer: a contiguous view whose
    base lacks the alignment that t's has."""
    buf = torch.zeros(t.numel() + by, device=t.device, dtype=t.dtype)
    buf[by:].copy_(t.reshape(-1))
    return buf[by:].view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("numel", FLAT_NUMELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_adam8bit_kernel_matches_plain(numel, dtype):
    """The flat kernel against its plain version on the card: codes, scales
    and the update (in g's dtype) bit for bit — both run the same explicitly
    rounded f32 operations in one order, and the same midpoint rule."""
    dev = _cuda_device()
    g, moments = _flat_on(dev, numel)
    g = g.to(getattr(torch, dtype))
    if numel == 1000 * 520:
        g = g.view(1000, 520)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    want = a8.adam8bit_update_plain(g, *moments, count)
    before = a8.adam8bit_update.launches
    mine = [t.clone() for t in moments]
    got = a8.adam8bit_update(g, *mine, count)
    torch.cuda.synchronize()
    assert a8.adam8bit_update.launches == before + 1
    assert all(a is b for a, b in zip(got[1:], mine))  # codes and scales updated in place
    assert got[0].shape == g.shape and got[0].dtype == g.dtype
    for name, a, b in zip(["update", "mq", "ms", "vq", "vs"], got, want):
        assert torch.equal(a, b), f"{numel} {dtype} {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("numel", FLAT_NUMELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_adam8bit_kernel_unaligned_matches_plain(numel, dtype):
    """g, codes and update at odd offsets of larger buffers (too little
    alignment for the kernel's 16- and 8-byte words): the element-wise path,
    still bit for bit the plain version."""
    dev = _cuda_device()
    g, moments = _flat_on(dev, numel)
    g = _offset(g.to(getattr(torch, dtype)))
    mine = [_offset(t) for t in moments]
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    want = a8.adam8bit_update_plain(g, *moments, count)
    got = a8.adam8bit_update(g, *mine, count)
    torch.cuda.synchronize()
    for name, a, b in zip(["update", "mq", "ms", "vq", "vs"], got, want):
        assert torch.equal(a, b), f"{numel} {dtype} {name}"


@pytest.mark.cuda
def test_cuda_adam8bit_wrapper_rejects_wrong_inputs():
    dev = _cuda_device()
    g, (mq, ms, vq, vs) = _flat_on(dev, 700)
    count = torch.tensor(1, dtype=torch.int32, device=dev)
    fn = a8.adam8bit_update
    before = fn.launches
    with pytest.raises(TypeError):  # an f16 gradient
        fn(g.half(), mq, ms, vq, vs, count)
    with pytest.raises(TypeError):  # f32 codes
        fn(g, mq.float(), ms, vq, vs, count)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        fn(g, mq, ms.cpu(), vq, vs, count)
    with pytest.raises(ValueError):  # a non-contiguous gradient
        fn(torch.zeros(2, 700, device=dev)[:, ::2].t(), mq, ms, vq, vs, count)
    with pytest.raises(ValueError):  # codes for another number of blocks
        fn(g[:200].contiguous(), mq, ms, vq, vs, count)
    with pytest.raises(TypeError):  # an int64 count
        fn(g, mq, ms, vq, vs, count.long())
    assert fn.launches == before


# ---------------------------------------------------------------------------
# the fp32-moment kernels reading a packed int4 P
# ---------------------------------------------------------------------------

INT4P_SHAPES = [(72, 16, 130), (1000, 96, 520), (3, 72, 16, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", INT4P_SHAPES)
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("w_dtype", [None, "float32", "bfloat16"])
def test_cuda_int4p_kernel_equals_dequantized_launch(shape, side, w_dtype):
    """B1/B2 and their apply forms (w_dtype) launched on a packed int4 P give
    G̃ (or W'), M' and V' bit for bit as the same kernel launched on the
    host-dequantized P — only the staging differs — and agree with the plain
    version (1e-5·max; W' as in the apply test)."""
    dev = _cuda_device()
    P, G, M, V = (torch.from_numpy(a).to(dev) for a in fused_inputs(shape, side))
    P4 = codec.quant4_axis_state(P)
    P_host = codec.dequantize4_axis(P4["q"], P4["scale"], P.shape[-2]).contiguous()
    G = G.to(torch.bfloat16)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    right = side == "right"
    if w_dtype is None:
        fn = tk.galore_fused_adam_step_right if right else tk.galore_fused_adam_step
        plain = (tk.galore_fused_adam_step_right_plain if right
                 else tk.galore_fused_adam_step_plain)
        kw, W = dict(alpha=0.25), None
    else:
        fn = tk.galore_fused_adam_apply_step_right if right else tk.galore_fused_adam_apply_step
        plain = (tk.galore_fused_adam_apply_step_right_plain if right
                 else tk.galore_fused_adam_apply_step_plain)
        kw = dict(eta=torch.tensor(-1e-3, device=dev), **APPLY_KW)
        W = _w_on(dev, shape, w_dtype)

    def run(P_):
        args = (P_, G) + (() if W is None else (W.clone(),)) + (M.clone(), V.clone(), count)
        return [t.clone() for t in fn(*args, **kw)]

    before, before4 = fn.launches, fn.launches_int4
    got = run(P4)
    host = run(P_host)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_int4) == (before + 1, before4 + 1)
    tag = f"{side} {shape} W {w_dtype}"
    for name, a, b in zip(["out", "m", "v"], got, host):
        assert torch.equal(a, b), f"{tag} {name}: the int4 launch differs from the f32 one"
    want = plain(P4, G, *(() if W is None else (W,)), M, V, count, **kw)
    if W is None:
        assert_close(got[0], want[0].cpu().numpy(), f"{tag} update")
    else:
        assert_weight_close(got[0], want[0], W, f"{tag} W", tol=1e-5, ulps=2)
    assert_close(got[1], want[1].cpu().numpy(), f"{tag} m")
    assert_close(got[2], want[2].cpu().numpy(), f"{tag} v")


@pytest.mark.cuda
def test_cuda_int4p_and_flat_never_run_the_plain_version(monkeypatch):
    dev = _cuda_device()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("galore_fused_adam_step_plain", "galore_fused_adam_step_right_plain",
                 "galore_fused_adam_apply_step_plain", "galore_fused_adam_apply_step_right_plain"):
        monkeypatch.setattr(tk, name, refuse)
    monkeypatch.setattr(a8, "adam8bit_update_plain", refuse)
    count = torch.tensor(1, dtype=torch.int32, device=dev)
    eta = torch.tensor(-1e-3, device=dev)
    for shape, side in (((72, 16, 130), "left"), ((130, 16, 72), "right")):
        right = side == "right"
        P, G, M, V = (torch.from_numpy(a).to(dev) for a in fused_inputs(shape, side))
        P4 = codec.quant4_axis_state(P)
        fn = tk.galore_fused_adam_step_right if right else tk.galore_fused_adam_step
        fn(P4, G, M, V, count)
        fn = tk.galore_fused_adam_apply_step_right if right else tk.galore_fused_adam_apply_step
        fn(P4, G, _w_on(dev, shape, "bfloat16"), M, V, count, eta=eta)
    g, moments = _flat_on(dev, 700)
    a8.adam8bit_update(g, *moments, count)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_int4p_wrappers_reject_wrong_projectors():
    dev = _cuda_device()
    P, G, M, V = (torch.from_numpy(a).to(dev) for a in fused_inputs((72, 16, 130), "left"))
    P4 = codec.quant4_axis_state(P)
    count = torch.tensor(1, dtype=torch.int32, device=dev)
    fn = tk.galore_fused_adam_step
    before = (fn.launches, fn.launches_int4)
    with pytest.raises(TypeError):  # f32 codes
        fn({"q": P4["q"].float(), "scale": P4["scale"]}, G, M, V, count)
    with pytest.raises(ValueError):  # scales of another block count
        fn({"q": P4["q"], "scale": P4["scale"][:0]}, G, M, V, count)
    with pytest.raises(ValueError):  # codes on the host
        fn({"q": P4["q"].cpu(), "scale": P4["scale"]}, G, M, V, count)
    with pytest.raises(ValueError):  # non-contiguous codes
        fn({"q": P4["q"].t().contiguous().t(), "scale": P4["scale"]}, G, M, V, count)
    assert (fn.launches, fn.launches_int4) == before


# ---------------------------------------------------------------------------
# the tiled projections (B4, B5), the fp32 step's composite route, RMSNorm (B6)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PROJECT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transpose_g", [False, True])
def test_cuda_project_kernel_matches_plain(shape, dtype, transpose_g):
    """B4 against its plain version: R within 1e-5·max|want| + 1e-5·|want|,
    G f32 or bf16, stored as (..., m, n) or, with `transpose_g`, (..., n, m)."""
    dev = _cuda_device()
    P, G, _ = (torch.from_numpy(a).to(dev) for a in proj_inputs(shape))
    G = G.to(getattr(torch, dtype))
    if transpose_g:
        G = G.transpose(-1, -2).contiguous()
    want = tp.galore_project_plain(P, G, transpose_g)
    before = tp.galore_project.launches
    got = tp.galore_project(P, G, transpose_g=transpose_g)
    torch.cuda.synchronize()
    assert tp.galore_project.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_close(got, want.cpu().numpy(), f"{shape} {dtype} transpose_g {transpose_g}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PROJECT_SHAPES)
@pytest.mark.parametrize("transpose_out", [False, True])
def test_cuda_project_back_kernel_matches_plain(shape, transpose_out):
    """B5 against its plain version (α = 0.25): G̃ within 1e-5·max|want| +
    1e-5·|want|, written as (..., m, n) or, with `transpose_out`, (..., n, m)."""
    dev = _cuda_device()
    P, _, N = (torch.from_numpy(a).to(dev) for a in proj_inputs(shape))
    want = tp.galore_project_back_plain(P, N, 0.25, transpose_out)
    before = tp.galore_project_back.launches
    got = tp.galore_project_back(P, N, 0.25, transpose_out=transpose_out)
    torch.cuda.synchronize()
    assert tp.galore_project_back.launches == before + 1
    assert got.shape == want.shape and got.is_contiguous()
    assert_close(got, want.cpu().numpy(), f"{shape} transpose_out {transpose_out}")


def tf32_rna(x):
    """x (f32) rounded to TF32 (10 explicit mantissa bits) to nearest, ties
    away from zero, as cvt.rna.tf32.f32 does: add half a TF32 ulp to the
    magnitude bits, then clear the 13 bits below."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32_matmul(A, B, b_exact=False, chunk=32):
    """A (M, K) @ B (K, N) as the kernels compute it: A = A_hi + A_lo and B =
    B_hi + B_lo in TF32, the products exact, each 32-deep k-tile's passes
    (A_lo·B_hi + A_hi·B_lo + A_hi·B_hi, or A_lo·B + A_hi·B when B is exact
    in TF32) summed in f32 and added into an f32 accumulator."""
    a_hi = tf32_rna(A)
    a_lo = tf32_rna(A - a_hi)
    b_hi = tf32_rna(B)
    b_lo = tf32_rna(B - b_hi)
    if b_exact:
        assert np.array_equal(b_hi, B)
    acc = np.zeros((A.shape[0], B.shape[1]), np.float32)
    for k in range(0, A.shape[1], chunk):
        s = slice(k, k + chunk)
        part = a_lo[:, s] @ b_hi[s]
        if not b_exact:
            part += a_hi[:, s] @ b_lo[s]
        part += a_hi[:, s] @ b_hi[s]
        acc += part
    return acc


def within_gate(got, want):
    """The kernels' gate: |got - want| ≤ 1e-5·max|want| + 1e-5·|want|."""
    return bool(np.all(np.abs(got - want) <= 1e-5 * np.abs(want).max() + 1e-5 * np.abs(want)))


# the split-TF32 model's cases: B4 with G f32 (three passes) or bf16 (two
# passes), and B5 (three passes)
SPLIT_CASES = ["project f32", "project bf16", "project_back"]


def split_tf32_inputs(case):
    """One case at a small shape with a ragged k-tile (m = 520, r = 264, n =
    130): P (m, r) with orthonormal columns, as every GaLore projector; X, the
    case's second operand (G (m, n), its bf16 values widened to f32 for
    "project bf16", or N (r, n)); and the model's A, B and whether B is exact
    in TF32 (R = Pᵀ G: A = Pᵀ, B = G; G̃ = P N: A = P, B = N)."""
    rng = np.random.default_rng(11)
    m, r, n = 520, 264, 130
    P = np.linalg.qr(rng.standard_normal((m, r)))[0].astype(np.float32)
    if case == "project_back":
        N = rng.standard_normal((r, n)).astype(np.float32)
        return P, N, P, N, False
    G = rng.standard_normal((m, n)).astype(np.float32)
    exact = case.endswith("bf16")
    if exact:  # the bf16 values, widened to f32 as the kernel reads them
        G = torch.from_numpy(G).to(torch.bfloat16).float().numpy()
    return P, G, np.ascontiguousarray(P.T), G, exact


# (lead..., m, r, n) checked on the card only: the r = 1024 leaves of
# llama_7b with 2 layers (wq wk wv wo; gate up; down, whose G B4 reads and
# whose G̃ B5 writes transposed) and dims no 16-byte row holds, which the
# kernel copies element by element instead of by TMA
CARD_PROJECT_SHAPES = [(2, 4096, 1024, 4096), (2, 4096, 1024, 11008), (1, 37, 21, 45),
                       (3, 61, 13, 7)]


def _thread_copied(shape) -> int:
    """1 where the kernel copies the operands of a CARD_PROJECT_SHAPES entry
    by its threads (P's rows of r floats not a multiple of 16 bytes), 0 where
    the TMA copies them."""
    return int(shape[-2] % 4 != 0)


def _card_proj_inputs(shape, dev, seed=7):
    """P (orthonormal columns), G and N of one (lead..., m, r, n) shape, drawn
    on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead, (m, r, n) = tuple(shape[:-3]), shape[-3:]
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    return (torch.linalg.qr(rnd(*lead, m, r))[0].contiguous(), rnd(*lead, m, n),
            rnd(*lead, r, n))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_PROJECT_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("transpose_g", [False, True])
def test_cuda_project_kernel_at_rank_1024_and_odd_dims(shape, dtype, transpose_g):
    """B4 (split TF32) against its plain version at the r = 1024 leaves (K =
    4096 deep), G f32 or bf16 stored either way, and at dims no TMA row
    holds (K = 37 and 61, not multiples of the 32-deep k-tile): within
    1e-5·max|want| + 1e-5·|want|."""
    dev = _cuda_device()
    P, G, _ = _card_proj_inputs(shape, dev)
    G = G.to(getattr(torch, dtype))
    if transpose_g:
        G = G.transpose(-1, -2).contiguous()
    want = tp.galore_project_plain(P, G, transpose_g)
    before = tp.galore_project.launches_thread_copy
    got = tp.galore_project(P, G, transpose_g=transpose_g)
    torch.cuda.synchronize()
    assert tp.galore_project.launches_thread_copy == before + _thread_copied(shape)
    tol = 1e-5 * want.abs().max() + 1e-5 * want.abs()
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_PROJECT_SHAPES)
@pytest.mark.parametrize("transpose_out", [False, True])
def test_cuda_project_back_kernel_at_rank_1024_and_odd_dims(shape, transpose_out):
    """B5 (split TF32) against its plain version (α = 0.25) at the r = 1024
    leaves and at dims no TMA row holds, G̃ written as (..., m, n) or
    transposed: within 1e-5·max|want| + 1e-5·|want|."""
    dev = _cuda_device()
    P, _, N = _card_proj_inputs(shape, dev)
    want = tp.galore_project_back_plain(P, N, 0.25, transpose_out)
    before = tp.galore_project_back.launches_thread_copy
    got = tp.galore_project_back(P, N, 0.25, transpose_out=transpose_out)
    torch.cuda.synchronize()
    assert tp.galore_project_back.launches_thread_copy == before + _thread_copied(shape)
    assert got.shape == want.shape and got.is_contiguous()
    tol = 1e-5 * want.abs().max() + 1e-5 * want.abs()
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_cuda_project_kernels_follow_the_split_tf32_model(case):
    """B4 (G f32 or bf16) and B5 (α = 1) on the card against
    split_tf32_matmul, the CPU model of their arithmetic, at the model's own
    small shape (m = 520, r = 264, n = 130): within the kernels' gate of the
    model's output, and not within it of one TF32 pass."""
    dev = _cuda_device()
    P, X, A, B, exact = split_tf32_inputs(case)
    Pd = torch.from_numpy(P).to(dev)
    if case == "project_back":
        got = tp.galore_project_back(Pd, torch.from_numpy(X).to(dev), 1.0)
    else:
        Xd = torch.from_numpy(X).to(dev)
        got = tp.galore_project(Pd, Xd.to(torch.bfloat16) if exact else Xd)
    got = got.cpu().numpy()
    model = split_tf32_matmul(A, B, b_exact=exact)
    assert within_gate(got, model), float(np.abs(got - model).max())
    one_pass = (tf32_rna(A).astype(np.float64) @ tf32_rna(B).astype(np.float64))
    assert not within_gate(got, one_pass.astype(np.float32))


# the adam8 and apply dispatchers, by name, and whether they take int8 moments
PLAIN_ROUTE_FORMS = [("galore_fused_adam8_step", True, False),
                     ("galore_fused_adam_apply_step", False, True),
                     ("galore_fused_adam8_apply_step", True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", PLAIN_ROUTE_FORMS, ids=lambda f: f[0])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("p_int4", [False, True])
def test_cuda_dispatch_plain_route_at_rank_1024(form, side, p_int4):
    """At a llama_7b leaf with r = 1024 (fits_vmem fails) each adam8 and apply
    dispatcher runs the plain step on the card, as the reference runs plain
    jnp there: no kernel launched, results equal to the plain step's, W and
    the moments updated in place, and no host synchronisation on the way
    (stochastic rounding included)."""
    dev = _cuda_device()
    name, int8, apply = form
    right = side == "right"
    m, r, n = (11008, 1024, 4096) if right else (4096, 1024, 11008)
    kept, mv = ((n, r), (m, r)) if right else ((m, r), (r, n))
    gen = torch.Generator(device=dev).manual_seed(3)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    P = torch.linalg.qr(rnd(1, *kept))[0].contiguous()
    if p_int4:
        P = codec.quant4_axis_state(P)
    G = rnd(1, m, n).to(torch.bfloat16)
    if int8:
        ax = -2 if right else -1
        moments = (*codec.quantize_axis(0.01 * rnd(1, *mv), axis=ax, signed=True),
                   *codec.quantize_axis(1e-4 * rnd(1, *mv).square(), axis=ax, signed=False))
    else:
        moments = (0.01 * rnd(1, *mv), 1e-4 * rnd(1, *mv).square())
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    kw = dict(alpha=0.25)
    if int8:
        kw["stochastic"] = True
    lead = ()
    if apply:
        kw.update(eta=torch.tensor(-1e-3, device=dev), wd=0.01)
        lead = ((0.02 * rnd(1, m, n)).to(torch.bfloat16),)
    full = name + ("_right" if right else "")
    want = getattr(ref, full)(P, G, *lead, *moments, count, **kw)
    mine = tuple(x.clone() for x in lead + moments)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = getattr(ops, full)(P, G, *mine, count, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(fn.launches == 0 for fn in tk.WRAPPERS)
    assert all(fn.launches_int4 == 0 for fn in tk.WRAPPERS[:2] + tk.WRAPPERS[4:6])
    assert (tp.galore_project.launches, tp.galore_project_back.launches) == (0, 0)
    if apply:
        assert all(a is b for a, b in zip(got, mine))
    else:
        assert all(a is b for a, b in zip(got[1:], mine))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_project_wrappers_reject_wrong_inputs(monkeypatch):
    """CPU/CUDA mixes, non-contiguous inputs, wrong dtypes and shapes are
    refused before any launch; a CUDA tensor never reaches a plain version."""
    dev = _cuda_device()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tp, "galore_project_plain", refuse)
    monkeypatch.setattr(tp, "galore_project_back_plain", refuse)
    P, G, N = (torch.from_numpy(a).to(dev) for a in proj_inputs((72, 16, 130)))
    before = (tp.galore_project.launches, tp.galore_project_back.launches)
    for bad, err in (((P.cpu(), G), ValueError), ((P, G.cpu()), ValueError),
                     ((P, G.t().contiguous().t()), ValueError), ((P, G.half()), TypeError),
                     ((P.double(), G), TypeError), ((P, G[:70].contiguous()), ValueError),
                     ((P[None], G), ValueError)):
        with pytest.raises(err):
            tp.galore_project(*bad)
    with pytest.raises(ValueError):  # (…, m, n) passed where the transpose is wanted
        tp.galore_project(P, G, transpose_g=True)
    for bad, err in (((P, N.cpu()), ValueError), ((P, N.t().contiguous().t()), ValueError),
                     ((P, N.to(torch.bfloat16)), TypeError), ((P, N[:8].contiguous()), ValueError)):
        with pytest.raises(err):
            tp.galore_project_back(*bad, 0.25)
    assert (tp.galore_project.launches, tp.galore_project_back.launches) == before
    tp.galore_project(P, G)
    tp.galore_project_back(P, N, 0.25, transpose_out=True)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("p_int4", [False, True])
def test_cuda_dispatch_composite_route(side, p_int4):
    """ops.galore_fused_adam_step[_right] at a shape that fails fits_vmem
    (P (2, 2048, 1024)): one launch each of B4 and B5, none of B1/B2, M and V
    updated in place, and G̃, M', V' within 1e-5·max of the plain step."""
    dev = _cuda_device()
    right = side == "right"
    shape = (2, 96, 1024, 2048) if right else (2, 2048, 1024, 96)
    P, G, M, V = (torch.from_numpy(a).to(dev) for a in fused_inputs(shape, side))
    if p_int4:
        P = codec.quant4_axis_state(P)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    fn = ops.galore_fused_adam_step_right if right else ops.galore_fused_adam_step
    plain = ref.galore_fused_adam_step_right if right else ref.galore_fused_adam_step
    want = plain(P, G, M, V, count, alpha=0.25)
    ops.reset_launch_counts()
    M2, V2 = M.clone(), V.clone()
    got = fn(P, G, M2, V2, count, alpha=0.25)
    torch.cuda.synchronize()
    fused = tk.galore_fused_adam_step_right if right else tk.galore_fused_adam_step
    assert (tp.galore_project.launches, tp.galore_project_back.launches) == (1, 1)
    assert fused.launches == fused.launches_int4 == 0
    assert got[1] is M2 and got[2] is V2
    for name, a, b in zip(["update", "m", "v"], got, want):
        assert_close(a, b.cpu().numpy(), f"{side} int4 P {p_int4} {name}")


# ---------------------------------------------------------------------------
# the int8-moment kernel at the models' leaves (split TF32 on the tensor
# cores, TMA-fed, each slab spread over a thread-block cluster)
# ---------------------------------------------------------------------------

# ((lead..., m, r, n), side): llama_7b's leaves with 2 layers at r = 128 (wq
# wk wv wo; gate up; down), llama_1b's at the paper's 1B rank r = 512 (gate
# up's G rows of 5461 bf16 are no multiple of 16 bytes: G by thread copies), r =
# 256 (two rank chunks: the apply form's N̂ scratch), and a ragged stacked
# leaf with r = 200 on each side
CARD8_CASES = [
    ((2, 4096, 128, 4096), "left"), ((2, 4096, 128, 11008), "left"),
    ((2, 11008, 128, 4096), "right"),
    ((2, 2048, 512, 2048), "left"), ((2, 2048, 512, 5461), "left"),
    ((2, 5461, 512, 2048), "right"),
    ((2, 4096, 256, 4096), "left"),
    ((3, 1000, 200, 520), "left"), ((3, 520, 200, 1000), "right"),
]


def _adam8_card_inputs(shape, side, dev, seed):
    """P (orthonormal columns), the int8 moments of step 7 (what six steps of
    the plain 8-bit version leave on gradients of unit scale) and an f32 G,
    all drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead, (m, r, n) = tuple(shape[:-3]), shape[-3:]
    left = side == "left"
    kept, mv = ((m, r), (r, n)) if left else ((n, r), (m, r))
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    P = torch.linalg.qr(rnd(*lead, *kept))[0].contiguous()
    ax = -1 if left else -2
    zeros = torch.zeros(*lead, *mv, device=dev)
    moments = (*codec.quantize_axis(zeros, axis=ax, signed=True),
               *codec.quantize_axis(zeros, axis=ax, signed=False))
    plain = ref.galore_fused_adam8_step if left else ref.galore_fused_adam8_step_right
    for t in range(1, 7):
        moments = plain(P, rnd(*lead, m, n), *moments,
                        torch.tensor(t, dtype=torch.int32, device=dev))[1:]
    return P, [x.contiguous() for x in moments], rnd(*lead, m, n)


def _copies8(shape, side, p_int4) -> int:
    """1 where the int8-moment kernel copies an operand of a bf16-G launch by
    its threads: a row of G, of an f32 P, or of an int4 P's codes or scales
    that is no multiple of 16 bytes."""
    m, r, n = shape[-3:]
    rows = [2 * n] + ([r, 4 * r] if p_int4 else [4 * r])
    return int(any(b % 16 for b in rows))


def _within(got, want):
    """|got - want| ≤ 1e-5·max|want| + 1e-5·|want|, and finite, on the card."""
    tol = 1e-5 * want.abs().max() + 1e-5 * want.abs()
    return bool(((got - want).abs() <= tol).all()) and bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD8_CASES, ids=lambda c: f"{c[1]}{c[0]}")
@pytest.mark.parametrize("apply", [False, True], ids=["emit", "apply"])
@pytest.mark.parametrize("p_int4", [False, True])
def test_cuda_adam8_kernel_at_model_leaves(case, apply, p_int4):
    """The int8-moment kernel (emit, or apply with W bf16), G bf16, P f32 or
    int4, at the models' leaves against its plain version: G̃ and the scales
    within 1e-5·max|want| + 1e-5·|want|, codes at most 1 apart, W' as the
    apply checks hold it; two launches on the same inputs bitwise equal; the
    thread-copy route taken exactly where an operand's rows are no multiple
    of 16 bytes; each slab spread over a cluster of 2 or 4 CTAs; outputs
    updated in place."""
    dev = _cuda_device()
    shape, side = case
    right = side == "right"
    P, moments, G = _adam8_card_inputs(shape, side, dev, seed=sum(shape))
    G = G.to(torch.bfloat16)
    if p_int4:
        P = codec.quant4_axis_state(P)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    name = ("galore_fused_adam8_apply_step" if apply else "galore_fused_adam8_step") + (
        "_right" if right else "")
    fn, plain = getattr(tk, name), getattr(tk, name + "_plain")
    kw, lead = dict(alpha=0.25), ()
    if apply:
        kw.update(eta=torch.tensor(-1e-3, device=dev), wd=0.01)
        gen = torch.Generator(device=dev).manual_seed(5)
        lead = ((0.02 * torch.randn(*shape[:-3], shape[-3], shape[-1], generator=gen,
                                    device=dev)).to(torch.bfloat16),)
    want = plain(P, G, *lead, *moments, count, **kw)
    runs = []
    for _ in range(2):
        ins = [x.clone() for x in lead + tuple(moments)]
        before = (fn.launches, fn.launches_thread_copy)
        got = fn(P, G, *ins, count, **kw)
        torch.cuda.synchronize()
        assert (fn.launches, fn.launches_thread_copy) == (
            before[0] + 1, before[1] + _copies8(shape, side, p_int4))
        # at most 172 slabs: one CTA a slab would leave SMs idle
        assert tk.epilogue_last_cluster() in (2, 4)
        assert all(a is b for a, b in zip(got[-4:], ins[-4:]))
        if apply:
            assert got[0] is ins[0]
        runs.append(got)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    got = runs[0]
    tag = f"{side} {shape} {'apply' if apply else 'emit'} int4 P {p_int4}"
    if apply:
        assert_weight_close(got[0], want[0], lead[0], f"{tag} W", tol=1e-5, ulps=2)
    else:
        assert _within(got[0], want[0]), tag
    for name_, a, b in zip(["mq", "ms", "vq", "vs"], got[1:], want[1:]):
        if b.dtype == torch.uint8:
            assert int((a.int() - b.int()).abs().max()) <= 1, f"{tag} {name_}"
        else:
            assert _within(a, b), f"{tag} {name_}"


# cluster size -> a stacked leaf the host sends to it, left and right: a kept
# side of 32 (one 32-deep stage: one CTA a slab), of 64 (two stages: too few
# for four CTAs, and 16 slabs too few to fill the card alone) and of 640
# with 16 slabs (a cluster of four fills the card in one wave)
CLUSTER_CASES = {1: (2, 32, 16, 1000), 2: (2, 64, 48, 1000), 4: (2, 640, 200, 1000)}


@pytest.mark.cuda
@pytest.mark.parametrize("clusters", [1, 2, 4])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("apply", [False, True], ids=["emit", "apply"])
def test_cuda_adam8_each_cluster_size(clusters, side, apply):
    """The kernel at a stacked leaf that its host sends to 1, 2 or 4 CTAs a
    cluster (int4 P, stochastic rounding; two rank chunks at C = 4): the
    launch takes that size, and its results are within the gates of the
    plain step's."""
    dev = _cuda_device()
    L, kept, r, swept = CLUSTER_CASES[clusters]
    shape = (L, swept, r, kept) if side == "right" else (L, kept, r, swept)
    P, moments, G = _adam8_card_inputs(shape, side, dev, seed=clusters)
    P = codec.quant4_axis_state(P)
    G = G.to(torch.bfloat16)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    name = ("galore_fused_adam8_apply_step" if apply else "galore_fused_adam8_step") + (
        "_right" if side == "right" else "")
    kw, lead = dict(alpha=0.25, stochastic=True), ()
    if apply:
        kw.update(eta=torch.tensor(-1e-3, device=dev), wd=0.01)
        lead = ((0.02 * torch.randn(L, shape[-3], shape[-1], device=dev)),)
    want = getattr(tk, name + "_plain")(P, G, *lead, *moments, count, **kw)
    ins = [x.clone() for x in lead + tuple(moments)]
    got = getattr(tk, name)(P, G, *ins, count, **kw)
    torch.cuda.synchronize()
    assert tk.epilogue_last_cluster() == clusters
    if apply:
        assert_weight_close(got[0], want[0], lead[0], "W", tol=1e-5, ulps=2)
    else:
        assert _within(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        if b.dtype == torch.uint8:
            assert int((a.int() - b.int()).abs().max()) <= 1
        else:
            assert _within(a, b)


@pytest.mark.cuda
def test_cuda_adam8_never_falls_back_at_model_leaves(monkeypatch):
    """The four int8-moment wrappers at a llama_7b attention leaf and at
    llama_1b's gate/up leaf (the thread-copy route) launch the kernel: a CUDA
    tensor never reaches a plain version."""
    dev = _cuda_device()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("galore_fused_adam8_step", "galore_fused_adam8_step_right",
                 "galore_fused_adam8_apply_step", "galore_fused_adam8_apply_step_right"):
        monkeypatch.setattr(tk, name + "_plain", refuse)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    for shape, side in (((2, 4096, 128, 4096), "left"), ((2, 2048, 512, 5461), "left"),
                        ((2, 5461, 512, 2048), "right")):
        P, moments, G = _adam8_card_inputs(shape, side, dev, seed=1)
        G = G.to(torch.bfloat16)
        sfx = "_right" if side == "right" else ""
        getattr(tk, "galore_fused_adam8_step" + sfx)(P, G, *moments, count)
        W = torch.zeros(G.shape, dtype=torch.bfloat16, device=dev)
        getattr(tk, "galore_fused_adam8_apply_step" + sfx)(
            codec.quant4_axis_state(P), G, W, *moments, count,
            eta=torch.tensor(-1e-3, device=dev))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the fp32-moment apply form of galore_epilogue's kernel
# ---------------------------------------------------------------------------


def _fp32_card_inputs(shape, side, dev, seed):
    """P (orthonormal columns), the f32 moments of step 7 (what six Adam
    steps leave on compact gradients of unit scale), a bf16 G and a weight
    of the main path's scale, all drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lead, (m, r, n) = tuple(shape[:-3]), shape[-3:]
    kept, mv = ((m, r), (r, n)) if side == "left" else ((n, r), (m, r))
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    P = torch.linalg.qr(rnd(*lead, *kept))[0].contiguous()
    M = V = torch.zeros(*lead, *mv, device=dev)
    for t in range(1, 7):
        _, M, V = ref.lowrank_adam_update(rnd(*lead, *mv), M, V, torch.tensor(t, device=dev))
    return P, M.contiguous(), V.contiguous(), rnd(*lead, m, n).to(torch.bfloat16), 0.02 * rnd(
        *lead, m, n)


def _fp32_apply(side):
    right = side == "right"
    fn = tk.galore_fused_adam_apply_step_right if right else tk.galore_fused_adam_apply_step
    plain = (tk.galore_fused_adam_apply_step_right_plain if right
             else tk.galore_fused_adam_apply_step_plain)
    return fn, plain


def _own_gt(fn, P, G, M, V, count):
    """The kernel's own G̃: a launch on an f32 W of zeros with η = 1 and wd = 0
    writes W' = 0 + 1·(G̃ + 0·0) = G̃ exactly."""
    out = torch.zeros(G.shape, device=G.device)
    fn(P, G, out, M.clone(), V.clone(), torch.tensor(7, dtype=torch.int32, device=G.device),
       eta=torch.tensor(1.0, device=G.device), alpha=0.25, wd=0.0)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD8_CASES, ids=lambda c: f"{c[1]}{c[0]}")
@pytest.mark.parametrize("p_int4", [False, True])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_cuda_fp32_apply_kernel_at_model_leaves(case, p_int4, w_dtype):
    """The fp32-moment apply form, G bf16, P f32 or int4, W f32 or bf16, at
    the models' leaves against its plain version: M' and V' within
    1e-5·max|want| + 1e-5·|want|, W' as the apply checks hold it and bit for
    bit ref.apply_weight of the kernel's own G̃; two launches on the same
    inputs bitwise equal; an int4-P launch equal to the launch on the
    host-dequantized P; the thread-copy route taken exactly where an
    operand's rows are no multiple of 16 bytes; each slab spread over a
    cluster of 2 or 4 CTAs; outputs updated in place."""
    dev = _cuda_device()
    shape, side = case
    P, M, V, G, W32 = _fp32_card_inputs(shape, side, dev, seed=sum(shape))
    if p_int4:
        P4 = codec.quant4_axis_state(P)
        P, P_host = P4, codec.dequantize4_axis(P4["q"], P4["scale"], P.shape[-2]).contiguous()
    W = W32.to(getattr(torch, w_dtype))
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    eta = torch.tensor(-1e-3, device=dev)
    kw = dict(eta=eta, **APPLY_KW)
    fn, plain = _fp32_apply(side)
    want = plain(P, G, W, M, V, count, **kw)
    runs = []
    for P_ in (P, P) + ((P_host,) if p_int4 else ()):
        ins = [W.clone(), M.clone(), V.clone()]
        before = (fn.launches + fn.launches_int4, fn.launches_thread_copy)
        got = fn(P_, G, *ins, count, **kw)
        torch.cuda.synchronize()
        assert (fn.launches + fn.launches_int4, fn.launches_thread_copy) == (
            before[0] + 1, before[1] + _copies8(shape, side, p_int4 and P_ is P))
        assert tk.epilogue_last_cluster() in (2, 4)
        assert all(a is b for a, b in zip(got, ins))
        runs.append(got)
    for other in runs[1:]:  # again, and on the host-dequantized P
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    got = runs[0]
    tag = f"{side} {shape} int4 P {p_int4} W {w_dtype}"
    assert torch.equal(got[0], ref.apply_weight(W, _own_gt(fn, P, G, M, V, count), eta, 0.01)), tag
    assert_weight_close(got[0], want[0], W, f"{tag} W", tol=1e-5, ulps=2)
    assert _within(got[1], want[1]), f"{tag} m"
    assert _within(got[2], want[2]), f"{tag} v"


@pytest.mark.cuda
@pytest.mark.parametrize("clusters", [1, 2, 4])
@pytest.mark.parametrize("side", ["left", "right"])
def test_cuda_fp32_apply_each_cluster_size(clusters, side):
    """The fp32-moment apply form at a stacked leaf that its host sends to
    1, 2 or 4 CTAs a cluster (int4 P; two rank chunks at C = 4): the launch
    takes that size, its W' is bit for bit ref.apply_weight of its own G̃,
    and its results are within the gates of the plain step's."""
    dev = _cuda_device()
    L, kept, r, swept = CLUSTER_CASES[clusters]
    shape = (L, swept, r, kept) if side == "right" else (L, kept, r, swept)
    P, M, V, G, W = _fp32_card_inputs(shape, side, dev, seed=clusters)
    P = codec.quant4_axis_state(P)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    eta = torch.tensor(-1e-3, device=dev)
    fn, plain = _fp32_apply(side)
    want = plain(P, G, W, M, V, count, eta=eta, **APPLY_KW)
    got = fn(P, G, W.clone(), M.clone(), V.clone(), count, eta=eta, **APPLY_KW)
    torch.cuda.synchronize()
    assert tk.epilogue_last_cluster() == clusters
    assert torch.equal(got[0], ref.apply_weight(W, _own_gt(fn, P, G, M, V, count), eta, 0.01))
    assert_weight_close(got[0], want[0], W, "W", tol=1e-5, ulps=2)
    assert _within(got[1], want[1]) and _within(got[2], want[2])


@pytest.mark.cuda
def test_cuda_fp32_apply_never_falls_back_at_model_leaves(monkeypatch):
    """The fp32-moment apply wrappers at a llama_7b attention leaf, llama_1b's
    gate/up leaf (G by the threads) and its down leaf launch the kernel, P f32
    and int4: a CUDA tensor never reaches a plain version."""
    dev = _cuda_device()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("galore_fused_adam_apply_step_plain", "galore_fused_adam_apply_step_right_plain"):
        monkeypatch.setattr(tk, name, refuse)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    eta = torch.tensor(-1e-3, device=dev)
    for shape, side in (((2, 4096, 128, 4096), "left"), ((2, 2048, 512, 5461), "left"),
                        ((2, 5461, 512, 2048), "right")):
        P, M, V, G, W = _fp32_card_inputs(shape, side, dev, seed=1)
        fn, _ = _fp32_apply(side)
        before = fn.launches + fn.launches_int4
        fn(P, G, W.to(torch.bfloat16), M, V, count, eta=eta)
        fn(codec.quant4_axis_state(P), G, W, M, V, count, eta=eta)
        assert fn.launches + fn.launches_int4 == before + 2
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the fp32-moment emit form of galore_epilogue's kernel (B1, B2, int4 P)
# ---------------------------------------------------------------------------


def _fp32_emit(side):
    right = side == "right"
    fn = tk.galore_fused_adam_step_right if right else tk.galore_fused_adam_step
    plain = tk.galore_fused_adam_step_right_plain if right else tk.galore_fused_adam_step_plain
    return fn, plain


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD8_CASES, ids=lambda c: f"{c[1]}{c[0]}")
@pytest.mark.parametrize("p_int4", [False, True])
def test_cuda_fp32_emit_kernel_at_model_leaves(case, p_int4):
    """The fp32-moment emit form (B1/B2), G bf16, P f32 or int4, at the
    models' leaves against its plain version: G̃, M' and V' within
    1e-5·max|want| + 1e-5·|want|; two launches on the same inputs bitwise
    equal; an int4-P launch equal to the launch on the host-dequantized P;
    the thread-copy route taken exactly where an operand's rows are no
    multiple of 16 bytes; each slab spread over a cluster of 2 or 4 CTAs;
    M and V updated in place."""
    dev = _cuda_device()
    shape, side = case
    P, M, V, G, _ = _fp32_card_inputs(shape, side, dev, seed=sum(shape))
    if p_int4:
        P4 = codec.quant4_axis_state(P)
        P, P_host = P4, codec.dequantize4_axis(P4["q"], P4["scale"], P.shape[-2]).contiguous()
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    fn, plain = _fp32_emit(side)
    want = plain(P, G, M, V, count, alpha=0.25)
    runs = []
    for P_ in (P, P) + ((P_host,) if p_int4 else ()):
        ins = [M.clone(), V.clone()]
        before = (fn.launches + fn.launches_int4, fn.launches_thread_copy)
        got = fn(P_, G, *ins, count, alpha=0.25)
        torch.cuda.synchronize()
        assert (fn.launches + fn.launches_int4, fn.launches_thread_copy) == (
            before[0] + 1, before[1] + _copies8(shape, side, p_int4 and P_ is P))
        assert tk.epilogue_last_cluster() in (2, 4)
        assert got[1] is ins[0] and got[2] is ins[1]
        runs.append(got)
    for other in runs[1:]:  # again, and on the host-dequantized P
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    tag = f"{side} {shape} int4 P {p_int4}"
    for name, a, b in zip(("G̃", "m", "v"), runs[0], want):
        assert _within(a, b), f"{tag} {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("clusters", [1, 2, 4])
@pytest.mark.parametrize("side", ["left", "right"])
def test_cuda_fp32_emit_each_cluster_size(clusters, side):
    """The fp32-moment emit form at a stacked leaf that its host sends to 1,
    2 or 4 CTAs a cluster (int4 P; two rank chunks at C = 4, whose G̃ the
    second adds into): the launch takes that size, and G̃, M' and V' are
    within the gates of the plain step's."""
    dev = _cuda_device()
    L, kept, r, swept = CLUSTER_CASES[clusters]
    shape = (L, swept, r, kept) if side == "right" else (L, kept, r, swept)
    P, M, V, G, _ = _fp32_card_inputs(shape, side, dev, seed=clusters)
    P = codec.quant4_axis_state(P)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    fn, plain = _fp32_emit(side)
    want = plain(P, G, M, V, count, alpha=0.25)
    got = fn(P, G, M.clone(), V.clone(), count, alpha=0.25)
    torch.cuda.synchronize()
    assert tk.epilogue_last_cluster() == clusters
    assert all(_within(a, b) for a, b in zip(got, want))


# ((lead..., m, r, n), side) of leaves whose G rows (n elements) are no
# multiple of 16 bytes in bf16 or f32, so the threads copy G; P's rows suit
# the TMA
ODD_ROW_CASES = [((2, 64, 48, 999), "left"), ((2, 1000, 48, 333), "right")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ODD_ROW_CASES, ids=lambda c: f"{c[1]}{c[0]}")
@pytest.mark.parametrize("g_dtype", ["bfloat16", "float32"])
def test_cuda_fp32_emit_thread_copies_at_odd_rows(case, g_dtype):
    """The fp32-moment emit form at a leaf whose G rows defeat the TMA: the
    launch copies G by the threads and is counted in launches_thread_copy,
    and G̃ (written element by element where n is odd), M' and V' are within
    the gates of the plain step's."""
    dev = _cuda_device()
    shape, side = case
    P, M, V, G, _ = _fp32_card_inputs(shape, side, dev, seed=3)
    G = G.to(getattr(torch, g_dtype))
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    fn, plain = _fp32_emit(side)
    want = plain(P, G, M, V, count, alpha=0.25)
    before = (fn.launches, fn.launches_thread_copy)
    got = fn(P, G, M.clone(), V.clone(), count, alpha=0.25)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_thread_copy) == (before[0] + 1, before[1] + 1)
    assert all(_within(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_cuda_fp32_emit_never_runs_the_plain_version(monkeypatch):
    """The fp32-moment emit wrappers, and the dispatch above them, at a
    llama_7b attention leaf, llama_1b's gate/up leaf (G by the threads) and
    its down leaf launch the kernel, P f32 and int4: a CUDA tensor never
    reaches a plain version."""
    dev = _cuda_device()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    for name in ("galore_fused_adam_step_plain", "galore_fused_adam_step_right_plain"):
        monkeypatch.setattr(tk, name, refuse)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    for shape, side in (((2, 4096, 128, 4096), "left"), ((2, 2048, 512, 5461), "left"),
                        ((2, 5461, 512, 2048), "right")):
        P, M, V, G, _ = _fp32_card_inputs(shape, side, dev, seed=1)
        fn, _ = _fp32_emit(side)
        step = ops.galore_fused_adam_step_right if side == "right" else ops.galore_fused_adam_step
        before = fn.launches + fn.launches_int4
        fn(P, G, M, V, count)
        fn(codec.quant4_axis_state(P), G, M, V, count)
        step(P, G, M, V, count)
        assert fn.launches + fn.launches_int4 == before + 3
    torch.cuda.synchronize()


# (shape of x): test_kernels.py's rmsnorm shapes, a ragged 1000 x 520, the
# widest row the kernel takes, and rows of every width class in more rows
# than the grid holds at once (its thread blocks walk them): d = 1 and 7
# (element-wise), 4096 (two or four warps a row) and 8192 (four or eight)
RMSNORM_SHAPES = [(4, 64), (3, 7, 128), (1, 1024), (33, 96), (1000, 520), (2, 8192),
                  (2999, 1), (2999, 7), (2999, 4096), (2999, 8192)]


def assert_rmsnorm_close(got, want, name):
    """f32: within 1e-5 relative (and 1e-6 absolute); bf16: at most one bf16
    ulp apart (the kernel and the plain version each round one f32 value)."""
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    if got.dtype == torch.bfloat16:
        assert np.all(np.abs(g - w) <= _bf16_ulp(w)), name
    else:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMSNORM_SHAPES)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_kernel_matches_plain(shape, x_dtype, s_dtype):
    dev = _cuda_device()
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dev)
    scale = torch.from_numpy(rng.standard_normal(shape[-1:], np.float32) + 1).to(dev)
    x, scale = x.to(getattr(torch, x_dtype)), scale.to(getattr(torch, s_dtype))
    want = trms.rmsnorm_plain(x, scale)
    before = trms.rmsnorm.launches
    got = ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert trms.rmsnorm.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    assert_rmsnorm_close(got, want, f"{shape} x {x_dtype} scale {s_dtype}")


@pytest.mark.cuda
def test_cuda_rmsnorm_wrapper_rejects_wrong_inputs(monkeypatch):
    dev = _cuda_device()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(trms, "rmsnorm_plain", refuse)
    x = torch.randn(6, 64, device=dev)
    scale = torch.ones(64, device=dev)
    before = trms.rmsnorm.launches
    for bad, err in (((x.cpu(), scale), ValueError), ((x, scale.cpu()), ValueError),
                     ((x.t().contiguous().t()[:, ::2], scale[:32]), ValueError),
                     ((x.half(), scale), TypeError), ((x, scale.double()), TypeError),
                     ((x, scale[:32].contiguous()), ValueError),
                     ((torch.zeros(2, 8200, device=dev), torch.ones(8200, device=dev)),
                      ValueError)):
        with pytest.raises(err):
            trms.rmsnorm(*bad)
    assert trms.rmsnorm.launches == before
    trms.rmsnorm(x, scale)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 7, 520, 4096, 8192])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_dtype", ["float32", "bfloat16"])
def test_cuda_rmsnorm_kernel_at_offset_bases(d, x_dtype, s_dtype):
    """x and scale one element into larger buffers (bases the kernel's
    16-byte words cannot take): the element-wise path, within the gate."""
    dev = _cuda_device()
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((999, d), np.float32)).to(dev)
    scale = torch.from_numpy(rng.standard_normal(d, np.float32) + 1).to(dev)
    x = _offset(x.to(getattr(torch, x_dtype)))
    scale = _offset(scale.to(getattr(torch, s_dtype)))
    want = trms.rmsnorm_plain(x, scale)
    before = trms.rmsnorm.launches
    got = ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert trms.rmsnorm.launches == before + 1
    assert_rmsnorm_close(got, want, f"d {d} x {x_dtype} scale {s_dtype} at an offset")


@pytest.mark.cuda
def test_cuda_flat_and_rmsnorm_never_run_the_plain_version(monkeypatch):
    """Neither wrapper takes its plain version on a CUDA tensor, on the word
    path or the element path."""
    dev = _cuda_device()
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    flat = [(n, _flat_on(dev, n)) for n in (7, 4096, 1000 * 520)]
    norm = [torch.randn(33, d, device=dev) for d in (7, 520, 4096)]

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(a8, "adam8bit_update_plain", refuse)
    monkeypatch.setattr(trms, "rmsnorm_plain", refuse)
    launches = a8.adam8bit_update.launches, trms.rmsnorm.launches
    for _, (g, moments) in flat:
        for dtype in (torch.float32, torch.bfloat16):
            a8.adam8bit_update(g.to(dtype), *[t.clone() for t in moments], count)
            a8.adam8bit_update(_offset(g.to(dtype)), *[_offset(t) for t in moments], count)
    for x in norm:
        for dtype in (torch.float32, torch.bfloat16):
            scale = torch.ones(x.shape[-1], device=dev, dtype=dtype)
            trms.rmsnorm(x.to(dtype), scale)
            trms.rmsnorm(_offset(x.to(dtype)), _offset(scale))
    torch.cuda.synchronize()
    assert (a8.adam8bit_update.launches, trms.rmsnorm.launches) == (
        launches[0] + 4 * len(flat), launches[1] + 4 * len(norm))


# ---------------------------------------------------------------------------
# checkpoints and the guarded step on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_checkpoint_restore_bitwise(tmp_path):
    """CUDA leaves of every dtype the state holds (bf16 params, f32 moments,
    uint8 codes and f32 scales, an int32 count) come back from an async save
    bit for bit, on the card, although the live tensors are updated in place
    right after save returns; the CPU uint32 key and a host step round-trip
    too."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.projector import prng_key

    dev = _cuda_device()
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {"params": {"w": torch.randn(512, 384, device=dev, generator=gen).bfloat16()},
            "opt_state": ((), {"step": 5, "key": prng_key(3),
                               "inner": {"m": torch.randn(16, 384, device=dev, generator=gen),
                                         "v": {"q": torch.randint(0, 256, (16, 384), device=dev,
                                                                  dtype=torch.uint8,
                                                                  generator=gen),
                                               "scale": torch.rand(16, 3, device=dev,
                                                                   generator=gen)},
                                         "count": torch.tensor(5, dtype=torch.int32,
                                                               device=dev)}})}
    saved = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in _leaves(tree).items()}
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    ckpt.save(5, tree)
    for t in _leaves(tree).values():  # the next step's in-place updates
        if isinstance(t, torch.Tensor) and t.is_cuda:
            t.add_(1)
    ckpt.wait()
    target = {"params": {"w": torch.zeros(512, 384, device=dev, dtype=torch.bfloat16)},
              "opt_state": ((), {"step": 0, "key": prng_key(0),
                                 "inner": {"m": torch.zeros(16, 384, device=dev),
                                           "v": {"q": torch.zeros(16, 384, device=dev,
                                                                  dtype=torch.uint8),
                                                 "scale": torch.zeros(16, 3, device=dev)},
                                           "count": torch.zeros((), dtype=torch.int32,
                                                                device=dev)}})}
    restored = _leaves(ckpt.restore(5, target))
    assert sorted(restored) == sorted(saved)
    for k, want in saved.items():
        got = restored[k]
        if not isinstance(want, torch.Tensor):
            assert got == want, k
            continue
        assert got.dtype == want.dtype and got.device == want.device, k
        assert torch.equal(got, want), k


def _leaves(tree):
    from repro_torch.utils import tree_leaves_with_path

    return dict(tree_leaves_with_path(tree))


def _galore_launches():
    return sum(fn.launches for fn in tk.WRAPPERS)


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_cuda_guarded_skip_is_noop(moments):
    """On the card, a step the guard rejects (NaN gradients) launches no
    GaLore kernel and leaves params and every state leaf bit for bit; the
    next clean step launches the kernel once per GaLore leaf."""
    from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config
    from repro_torch.distributed.step import make_train_step
    from repro_torch.models import model as TM
    from repro_torch.quant import QuantPolicy
    from repro_torch.robust import FaultInjector, identity_fault, init_guard_state

    dev = _cuda_device()
    quant = QuantPolicy(moments="int8", projectors="int4") if moments == "int8" else QuantPolicy()
    tc = TrainConfig(galore=GaLoreConfig(rank=16, update_freq=4, quant=quant),
                     galore_fused_adam=True, weight_decay=0.01, total_steps=8, warmup_steps=1,
                     anomaly_guard=True, fault_hooks=True)
    cfg = get_config("llama_60m", smoke=True)
    params = TM.init_params(cfg, seed=0, device=dev)
    step, opt = make_train_step(cfg, tc)
    state = opt.init(params)
    guard = init_guard_state(dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32), device=dev)}
    params, state, guard, m = step(params, state, guard, batch, identity_fault(dev))
    assert int(m["guard_ok"]) == 1
    before = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in _leaves({"p": params, "s": state}).items()}
    launches = _galore_launches()
    params, state, guard, m = step(params, state, guard, batch,
                                   FaultInjector(["nan_grad@1"]).traced_fault(1, dev))
    torch.cuda.synchronize()
    assert int(m["guard_ok"]) == 0 and _galore_launches() == launches
    after = _leaves({"p": params, "s": state})
    for k, want in before.items():
        assert (torch.equal(after[k], want) if isinstance(want, torch.Tensor)
                else after[k] == want), k
    params, state, guard, m = step(params, state, guard, batch, identity_fault(dev))
    torch.cuda.synchronize()
    assert int(m["guard_ok"]) == 1 and _galore_launches() == launches + 7


# ---------------------------------------------------------------------------
# the refresh lifecycle on the card: ranks from rank_frac, the async driver
# ---------------------------------------------------------------------------


def _frac_rank(m, n, frac=0.1):
    from repro_torch.configs.base import GaLoreConfig
    from repro_torch.core.subspace import SubspaceManager

    return SubspaceManager(GaLoreConfig(rank_frac=frac)).leaf_rank("blocks.ffn.up", m, n)


# (kernel, side, (lead, m, r, n)) at rank_frac = 0.1: llama_60m's FFN leaves
# (r = 51, where the reference's fits_vmem holds) and llama_7b's (r = 409,
# where it fails, so the fp32 emit step composes B4 → Adam → B5)
RANK_FRAC_CASES = [("B1", "left", (2, 512, _frac_rank(512, 1376), 1376)),
                   ("B2", "right", (2, 1376, _frac_rank(1376, 512), 512)),
                   ("B3", "left", (2, 512, _frac_rank(512, 1376), 1376)),
                   ("B3", "right", (2, 1376, _frac_rank(1376, 512), 512)),
                   ("B4/B5", "left", (2, 4096, _frac_rank(4096, 11008), 11008))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", RANK_FRAC_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_cuda_rank_frac_ranks_through_each_kernel(case):
    """Ranks that rank_frac = 0.1 gives (51 and 409, not multiples of 8 or
    128) through the kernel the dispatch routes them to, each within its
    existing gate of its plain twin: B1/B2 and the int8 kernel (B3) where
    fits_vmem holds, B4 and B5 where it fails."""
    from repro_torch.kernels.galore_fused import fits_vmem

    kernel, side, shape = case
    lead, (m, r, n) = shape[:-3], shape[-3:]
    assert r % 8 and r in (51, 409)
    kept, swept = (m, n) if side == "left" else (n, m)
    assert fits_vmem(kept, r, swept, 2) == (kernel != "B4/B5")
    if kernel in ("B1", "B2"):
        test_cuda_kernel_matches_plain(shape, side, "bfloat16")
    elif kernel == "B3":
        test_cuda_adam8_kernel_matches_plain(shape, side, True, False)
    else:
        for transpose in (False, True):
            test_cuda_project_kernel_matches_plain(shape, "bfloat16", transpose)
            test_cuda_project_back_kernel_matches_plain(shape, transpose)


def _lifecycle_run(dev, tc, cfg, steps, sync):
    """train_loop on the card (`sync` False), or the async driver's schedule
    run synchronously in the main thread and on the main stream (`sync`
    True): swap at the boundary, refresh at step 0, at a due step the
    pending buffer from the previous batch's gradient at the current
    params, then the train step. Returns (losses, params, state)."""
    import tempfile

    from repro_torch.data.pipeline import DataConfig, SyntheticC4
    from repro_torch.distributed.step import (
        make_async_refresh_step,
        make_refresh_step,
        make_swap_step,
        make_train_step,
    )
    from repro_torch.launch.train import RunConfig, galore_due_offsets, train_loop
    from repro_torch.models import model as TM

    if not sync:
        losses = []
        with tempfile.TemporaryDirectory() as ckpt:
            params, state, _, _ = train_loop(
                RunConfig(steps=steps, batch_per_host=4, seq_len=64, log_every=100,
                          ckpt_every=0, ckpt_dir=ckpt, device=str(dev)),
                tc, cfg=cfg, on_step=lambda s, m: losses.append(float(m["loss"])))
        return losses, params, state
    params = TM.init_params(cfg, seed=tc.seed, device=dev)
    step_fn, opt = make_train_step(cfg, tc)
    refresh, pend_fn, swap = (make_refresh_step(cfg, tc), make_async_refresh_step(cfg, tc),
                              make_swap_step(cfg, tc))
    offsets, T = galore_due_offsets(params, tc), tc.galore.update_freq
    data = SyntheticC4(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_per_host=4),
                       device=dev)
    state = opt.init(params)
    pending, prev, losses = None, None, []
    for s in range(steps):
        b = data.batch(s)
        if pending is not None:
            state, pending = swap(state, pending, params), None
        stale, prev = (prev if prev is not None else b), b
        if s == 0:
            state = refresh(params, state, b, 0)
        elif s % T in offsets:
            pending = pend_fn(params, {k: v for k, v in state[1].items() if k != "inner"},
                              stale, s)
        params, state, m = step_fn(params, state, b)
        losses.append(float(m["loss"]))
    if pending is not None:
        state = swap(state, pending, params)
    return losses, params, state


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_cuda_async_driver_matches_synchronous_refresh(moments):
    """The async driver on the card — the refresh's gradient on a stream of
    its own, its SVDs on a host thread — against the same schedule run
    synchronously on the main stream (llama_60m at full width, 2 layers,
    staggered T = 4, moments re-projected): every loss, param and state leaf
    bit for bit, so no train step wrote the params before the refresh read
    them and no pending tensor was reused early; the GaLore kernel ran."""
    import dataclasses

    from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config
    from repro_torch.quant import QuantPolicy

    dev = _cuda_device()
    cfg = dataclasses.replace(get_config("llama_60m"), n_layers=2)
    quant = QuantPolicy(moments="int8", projectors="int4") if moments == "int8" else QuantPolicy()
    tc = TrainConfig(galore=GaLoreConfig(rank=64, update_freq=4, refresh_stagger=True,
                                         reproject_moments=True, quant=quant),
                     galore_refresh_async=True, galore_fused_adam=True, weight_decay=0.01,
                     total_steps=9, warmup_steps=1)
    before = _galore_launches()
    got = _lifecycle_run(dev, tc, cfg, 9, sync=False)
    assert _galore_launches() - before == 7 * 9  # one launch per GaLore leaf and step
    want = _lifecycle_run(dev, tc, cfg, 9, sync=True)
    assert got[0] == want[0]
    for name, a, b in (("params", got[1], want[1]), ("state", got[2], want[2])):
        a, b = _leaves(a), _leaves(b)
        assert sorted(a) == sorted(b)
        for k in a:
            assert (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                    else a[k] == b[k]), (name, k)


@pytest.mark.cuda
def test_cuda_rank_frac_training_run():
    """llama_60m at full width (2 layers) trained 8 steps with rank_frac =
    0.1, fused: r = 51 on the attention and FFN leaves, and r = 1 on the
    stacked norm scales (2, 512), which rank_frac makes GaLore leaves as the
    reference's plans do (max(1, 0.1·2) = 1 < min(2, 512)); B1 on the six
    left matrices and the two norm leaves and B2 on the down leaf each step,
    losses finite and within 5e-2 of the composable run's."""
    import dataclasses
    import tempfile

    from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config
    from repro_torch.launch.train import RunConfig, train_loop

    dev = _cuda_device()
    cfg = dataclasses.replace(get_config("llama_60m"), n_layers=2)
    runs = {}
    for fused in (True, False):
        tc = TrainConfig(galore=GaLoreConfig(rank=128, rank_frac=0.1, update_freq=4),
                         galore_fused_adam=fused, total_steps=8, warmup_steps=1)
        losses = []
        left, right = (tk.galore_fused_adam_step.launches,
                       tk.galore_fused_adam_step_right.launches)
        with tempfile.TemporaryDirectory() as ckpt:
            _, state, _, _ = train_loop(
                RunConfig(steps=8, batch_per_host=4, seq_len=64, log_every=100, ckpt_every=0,
                          ckpt_dir=ckpt, device=str(dev)),
                tc, cfg=cfg, on_step=lambda s, m: losses.append(float(m["loss"])))
        runs[fused] = losses
        proj = state[1]["proj"]["blocks"]
        assert {t.shape[-1] for t in proj["attn"].values()} == {51}
        assert {t.shape[-1] for t in proj["ffn"].values()} == {51}
        assert proj["ln1"]["scale"].shape == proj["ln2"]["scale"].shape == (2, 1)
        launched = (tk.galore_fused_adam_step.launches - left,
                    tk.galore_fused_adam_step_right.launches - right)
        assert launched == ((64, 8) if fused else (0, 0))
    assert all(np.isfinite(runs[True]))
    np.testing.assert_allclose(runs[True], runs[False], rtol=0, atol=5e-2)


# ---------------------------------------------------------------------------
# the paper's baselines on the card: Adafactor, SGD, GaLore-SGD, LoRA; and
# the W-in-place step after a mid-run refresh
# ---------------------------------------------------------------------------


def _all_launches():
    return (sum(fn.launches for fn in tk.WRAPPERS) + a8.adam8bit_update.launches
            + tp.galore_project.launches + tp.galore_project_back.launches)


def _f32_llama60m():
    import dataclasses

    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config("llama_60m"), n_layers=2, dtype="float32")


def _planted_grads(params, seed):
    """numpy gradients shaped like `params`: each leaf of ≥ 2 dims whose
    short side exceeds 64 carries a planted rank-32 part, singular values
    10, 11.25, …, 48.75, over noise of ≈ 0.2 (a GaLore refresh at rank 32
    finds a well-separated subspace); the rest Gaussian."""
    from repro_torch.utils import tree_map

    rng = np.random.default_rng(seed)

    def leaf(p):
        s = tuple(p.shape)
        g = rng.standard_normal(s).astype(np.float32)
        if len(s) >= 2 and min(s[-2:]) > 64:
            U = np.linalg.qr(rng.standard_normal(s[:-2] + (s[-2], 32)))[0]
            V = np.linalg.qr(rng.standard_normal(s[:-2] + (s[-1], 32)))[0]
            sv = 10.0 * (1 + np.arange(32) / 8)
            g = ((U * sv) @ V.swapaxes(-1, -2) + 0.1 * g / np.sqrt(s[-1])).astype(np.float32)
        return g

    return tree_map(leaf, params)


BASELINE_FORMS = {"adafactor": dict(optimizer="adafactor"), "sgd": dict(optimizer="sgd"),
                  "galore-sgd": dict(optimizer="sgd", galore=dict(rank=32, update_freq=4),
                                     galore_external_refresh=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(BASELINE_FORMS))
def test_cuda_baseline_optimizer_steps_match_cpu(form):
    """Two optimizer steps (clip → Adafactor / SGD's momentum trace /
    GaLore-SGD → −lr) over llama_60m's leaves at full width (2 layers, f32),
    on the card and on a CPU copy of the same params, gradients and initial
    state: every update and every state leaf within 1e-5·max of the CPU's;
    no kernel is launched; and the Adafactor update makes no host
    synchronisation (its RMS clip stays on the device). GaLore-SGD's
    projectors come from one external refresh on each device, the card's by
    cuSOLVER's gesvd, the CPU's by LAPACK. Their bases differ by a rotation
    within the subspace (column signs at least), so GaLore-SGD is held where
    the basis cancels: the updates within 2e-5·max of the CPU's (a GaLore
    update's gate), each projector's subspace overlap with the CPU's above
    0.999, and the compact momentum as the back-projected P·M (M·Pᵀ on a
    right leaf) within 2e-5·max."""
    from repro_torch.configs.base import GaLoreConfig, TrainConfig
    from repro_torch.core.galore import refresh_projectors
    from repro_torch.core.projector import subspace_overlap
    from repro_torch.models import model as TM
    from repro_torch.optim.adafactor import scale_by_adafactor
    from repro_torch.optim.factory import build_optimizer, galore_state_index
    from repro_torch.utils import tree_leaves_with_path, tree_map

    dev = _cuda_device()
    kw = dict(BASELINE_FORMS[form])
    g = kw.pop("galore", None)
    tc = TrainConfig(galore=GaLoreConfig(**g) if g else None, lr=1e-3, total_steps=8,
                     warmup_steps=1, **kw)
    cpu_params = TM.init_params(_f32_llama60m(), seed=0, device="cpu")
    grads = [_planted_grads(cpu_params, seed) for seed in (21, 22)]
    state0 = build_optimizer(tc).init(cpu_params)
    runs, projs = {}, {}
    for where in ("cpu", "cuda"):
        params = tree_map(lambda t: t.detach().to(where), cpu_params)
        # the state's key stays a CPU tensor, as prng_key makes it
        state = tree_map(lambda t: t.to(where, copy=True) if isinstance(t, torch.Tensor)
                         and t.dtype != torch.uint32 else t, state0)
        if g is not None:
            i = galore_state_index(tc)
            refreshed = refresh_projectors(
                tree_map(lambda a: torch.from_numpy(a).to(where), grads[0]), state[i],
                tc.galore)
            state = state[:i] + (refreshed,) + state[i + 1:]
        opt = build_optimizer(tc)
        before = _all_launches()
        ups = []
        for gs in grads:
            upd, state = opt.update(tree_map(lambda a: torch.from_numpy(a).to(where), gs),
                                    state, params)
            ups.append(upd)
        torch.cuda.synchronize()
        assert _all_launches() == before, f"{form} launched a kernel on {where}"
        runs[where] = [dict(tree_leaves_with_path(t)) for t in ups + [state]]
        if g is not None:  # each projector out, its leaf's momentum back-projected
            flat = runs[where][-1]
            projs[where] = {k: flat.pop(k) for k in list(flat)
                            if k.startswith(f"{i}.proj.") and flat[k].ndim >= 2}
            for k, P in projs[where].items():
                m = k.replace(".proj.", ".inner.", 1)
                left = flat[m].shape[-2] == P.shape[-1]
                flat[m] = P @ flat[m] if left else flat[m] @ P.transpose(-1, -2)
    for k, P in projs.get("cpu", {}).items():
        ov = subspace_overlap(projs["cuda"][k].cpu(), P)
        assert float(ov.min()) > 0.999, (k, ov)
    for want_t, got_t in zip(runs["cpu"], runs["cuda"]):
        assert sorted(want_t) == sorted(got_t)
        for k, want in want_t.items():
            got = got_t[k]
            if not isinstance(want, torch.Tensor):
                assert got == want, k
                continue
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert got.is_cuda == (want.dtype != torch.uint32), k
            if not want.is_floating_point():  # counts and the key
                assert torch.equal(got.cpu(), want), k
                continue
            err = float((got.cpu() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            assert err <= (2e-5 if g is not None else 1e-5), (k, err)
    if form == "adafactor":
        params = tree_map(lambda t: t.detach().to(dev), cpu_params)
        opt = scale_by_adafactor()
        state = opt.init(params)
        gs = tree_map(lambda a: torch.from_numpy(a).to(dev), grads[0])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.update(gs, state)
        finally:
            torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_cuda_lora_step_matches_cpu():
    """One step of the LoRA loop (benchmarks/table2_methods.py::_train_lowrank's
    merge → loss → adaptor gradients → Adam → −lr), llama_60m at full width
    (2 layers, f32, r = 64), B drawn non-zero so A and B both move, on the
    card and on a CPU copy: the loss within 1e-5 relative, the adaptor
    gradients and Adam's m and v within 1e-5·max of the CPU's, and the
    stepped adaptors within 1e-5·max wherever the gradient is above
    1e-4·max|g| (below it, rounding decides the sign of Adam's normalised
    first step, ±lr either way), no kernel launched."""
    from repro_torch.data.pipeline import DataConfig, SyntheticC4
    from repro_torch.models import model as TM
    from repro_torch.optim import lowrank
    from repro_torch.optim.adam import scale_by_adam
    from repro_torch.optim.transform import apply_updates
    from repro_torch.utils import tree_leaves_with_path, tree_map

    _cuda_device()
    cfg = _f32_llama60m()
    lcfg = lowrank.LoraConfig(rank=64, alpha=32)
    cpu_params = TM.init_params(cfg, seed=0, device="cpu")
    cpu_ad = lowrank.init_adaptors(cpu_params, lcfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, t in tree_leaves_with_path(cpu_ad):
            if k.endswith(".B"):
                t.copy_(0.02 * torch.randn(t.shape, generator=gen))
    batch = SyntheticC4(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_per_host=4),
                        device="cpu").batch(0)
    runs = {}
    for where in ("cpu", "cuda"):
        params = tree_map(lambda t: t.detach().to(where), cpu_params)
        ad = tree_map(lambda t: t.detach().to(where, copy=True).requires_grad_(t.requires_grad),
                      cpu_ad)
        opt = scale_by_adam()
        st = opt.init(ad)
        before = _all_launches()
        loss, _ = TM.loss_fn(cfg, lowrank.merge(params, ad, lcfg),
                             {k: v.to(where) for k, v in batch.items()})
        grads = lowrank.adaptor_grads(loss, ad)
        with torch.no_grad():
            upd, st = opt.update(grads, st, ad)
            apply_updates(ad, tree_map(lambda u: -1e-3 * u, upd))
        assert _all_launches() == before
        runs[where] = (float(loss.detach()),
                       {k: t.detach().cpu() for k, t in tree_leaves_with_path(
                           {"ad": ad, "g": grads, "m": st["m"], "v": st["v"]})})
    assert abs(runs["cuda"][0] - runs["cpu"][0]) <= 1e-5 * abs(runs["cpu"][0])
    want, got = runs["cpu"][1], runs["cuda"][1]
    for k in want:
        w, g = want[k], got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        err = (g - w).abs()
        if w.ndim < 2:  # a placeholder of an unadapted leaf: 0, its step 0
            assert not g.any() and not w.any(), k
            continue
        if k.startswith("ad."):  # the stepped adaptor: where the data decide its sign
            grad = want["g." + k[3:]].abs()
            err = err[grad > 1e-4 * float(grad.max())]
        bound = 1e-5 * float(w.abs().max())
        assert float(err.max()) <= bound, (k, float(err.max()) / bound)


@pytest.mark.cuda
def test_cuda_apply_after_refresh_matches_emit():
    """The W-in-place step across mid-run refreshes: llama_60m at full width
    (2 layers, bf16, r = 128) trained 6 steps at T = 2 (refreshes at steps
    0, 2 and 4) through galore_fused_apply and through the fused emit step:
    the apply run launches only the apply kernels (6 left leaves and 1 right
    leaf a step), and its losses are within 5e-2 of the emit run's."""
    import dataclasses
    import tempfile

    from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config
    from repro_torch.launch.train import RunConfig, train_loop

    dev = _cuda_device()
    cfg = dataclasses.replace(get_config("llama_60m"), n_layers=2)
    runs = {}
    for apply in (False, True):
        tc = TrainConfig(galore=GaLoreConfig(rank=128, update_freq=2, scale=0.25),
                         galore_fused_adam=True, galore_fused_apply=apply, weight_decay=0.01,
                         total_steps=6, warmup_steps=1)
        ops.reset_launch_counts()
        losses = []
        with tempfile.TemporaryDirectory() as ckpt:
            train_loop(RunConfig(steps=6, batch_per_host=4, seq_len=64, log_every=100,
                                 ckpt_every=0, ckpt_dir=ckpt, device=str(dev)),
                       tc, cfg=cfg, on_step=lambda s, m: losses.append(float(m["loss"])))
        launched = {fn.__name__: fn.launches for fn in tk.WRAPPERS if fn.launches}
        want = ({"galore_fused_adam_apply_step": 36, "galore_fused_adam_apply_step_right": 6}
                if apply else {"galore_fused_adam_step": 36, "galore_fused_adam_step_right": 6})
        assert launched == want, (apply, launched)
        runs[apply] = losses
    assert all(np.isfinite(runs[True]))
    np.testing.assert_allclose(runs[True], runs[False], rtol=0, atol=5e-2)


# ---------------------------------------------------------------------------
# the refresh's SVD on the card: an orthonormal P at every main-path leaf
# ---------------------------------------------------------------------------


def _rank_deficient(rng, lead, m, n, k):
    A = rng.standard_normal(lead + (m, k)).astype(np.float32)
    return (A @ rng.standard_normal(lead + (k, n)).astype(np.float32)) / np.float32(np.sqrt(k))


# (name, shape, rank of G or None for full rank, ranks r to keep); llama_7b's
# leaves as the main path stacks them (L = 2): attention, gate/up and down
SVD_CASES = [("attn", (2, 4096, 4096), None, (128, 1024)),
             ("mlp", (2, 4096, 11008), None, (128, 1024)),
             ("down", (2, 11008, 4096), None, (128, 1024)),
             ("ragged", (1000, 520), None, (128,)),
             ("deficient-r128", (2, 4096, 4096), 64, (128,)),
             ("deficient-r1024", (2, 4096, 4096), 512, (1024,))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SVD_CASES, ids=lambda c: c[0])
def test_cuda_refresh_projector_orthonormal(case):
    """compute_projector on the card (cuSOLVER gesvd): max|PᵀP − I| ≤ 1e-4
    at every kept rank, and the kept subspace's overlap with f64 LAPACK's on
    the same G above 0.999. For a G of rank k < r only the top k columns
    have a defined subspace: the overlap is taken over them, orthonormality
    over all r."""
    from repro_torch.core.projector import compute_projector, subspace_overlap

    dev = _cuda_device()
    name, shape, k, ranks = case
    rng = np.random.default_rng(5)
    lead, (m, n) = shape[:-2], shape[-2:]
    G = (rng.standard_normal(shape).astype(np.float32) if k is None
         else _rank_deficient(rng, lead, m, n, k))
    Gc = torch.from_numpy(G)
    U64 = torch.linalg.svd(Gc.double(), full_matrices=False)[0]
    for r in ranks:
        P = compute_projector(Gc.to(dev), r)
        assert P.is_cuda and P.shape == lead + (m, r) and P.dtype == torch.float32
        P = P.cpu().double()
        eye = torch.eye(r, dtype=torch.float64)
        orth = float((P.transpose(-1, -2) @ P - eye).abs().max())
        assert orth <= 1e-4, (name, r, orth)
        kept = r if k is None else min(k, r)
        ov = subspace_overlap(P[..., :kept], U64[..., :kept])
        assert float(ov.min()) > 0.999, (name, r, ov)


# ---------------------------------------------------------------------------
# serving on the card: the paged steps and the engine against the CPU's
# ---------------------------------------------------------------------------


def _serve_model():
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as TM

    cfg = get_config("llama_60m", smoke=True)  # f32, 2 layers, d 64
    return cfg, TM.init_params(cfg, seed=1, device="cpu")


@pytest.mark.cuda
def test_cuda_paged_steps_match_cpu():
    """Chunked paged prefill (chunk 3 over blocks of 4, per-lane pos0, an
    inactive lane on scratch) and three batched decode steps on the card and
    on the CPU from the same params, pool, tables and tokens: every real
    position's logits and every block but scratch within 1e-5·max."""
    from repro_torch.distributed.step import make_paged_decode_step, make_paged_prefill_step
    from repro_torch.models import model as TM
    from repro_torch.serve import BlockAllocator
    from repro_torch.utils import tree_map

    dev = _cuda_device()
    cfg, cpu_params = _serve_model()
    nb, C, NB = 8, 3, 16
    rng = np.random.default_rng(4)
    prompts = {0: rng.integers(0, cfg.vocab_size, 7), 1: rng.integers(0, cfg.vocab_size, 11)}
    prefill, decode = make_paged_prefill_step(cfg), make_paged_decode_step(cfg)
    runs = {}
    for where in ("cpu", dev):
        params = tree_map(lambda t: t.detach().to(where), cpu_params)
        kv = TM.init_paged_cache(cfg, NB, 4, device=where)
        alloc = BlockAllocator(NB, 4, nb)
        done, out = {0: 0, 1: 0}, []
        for turn in range(5):
            chunk = np.zeros((3, C), np.int64)
            bt = np.zeros((3, nb), np.int32)
            pos0 = np.zeros((3,), np.int32)
            real = {}
            for lane, prompt in prompts.items():
                if (lane == 1 and turn == 0) or done[lane] == len(prompt):
                    continue
                c = min(C, len(prompt) - done[lane])
                alloc.ensure(lane, c)
                chunk[lane, :c] = prompt[done[lane]: done[lane] + c]
                bt[lane], pos0[lane], real[lane] = alloc.table_row(lane), done[lane], c
            logits, kv = prefill(params, kv, torch.from_numpy(bt).to(where),
                                 torch.from_numpy(pos0).to(where),
                                 torch.from_numpy(chunk).to(where))
            for lane, c in real.items():
                out.append(logits[lane, :c].cpu())
                alloc.advance(lane, c)
                done[lane] += c
        last = {0: 5, 1: 9}
        for _ in range(3):
            bt = np.zeros((3, nb), np.int32)
            pos = np.zeros((3,), np.int32)
            toks = np.zeros((3, 1), np.int64)
            for lane in prompts:
                alloc.ensure(lane, 1)
                bt[lane], pos[lane], toks[lane, 0] = (alloc.table_row(lane), alloc.length(lane),
                                                      last[lane])
            logits, kv = decode(params, kv, torch.from_numpy(bt).to(where),
                                torch.from_numpy(pos).to(where), torch.from_numpy(toks).to(where))
            for lane in prompts:
                out.append(logits[lane].cpu())
                alloc.advance(lane, 1)
        out += [kv["kp"][:, 1:].cpu(), kv["vp"][:, 1:].cpu()]
        runs[str(where)] = out
    for want, got in zip(runs["cpu"], runs[str(dev)]):
        err = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
        assert err <= 1e-5, err


@pytest.mark.cuda
def test_cuda_engine_greedy_matches_cpu():
    """The Engine on the card gives the CPU engine's greedy tokens (chunked
    prefill, two lanes, a preempting tight pool), and a steady greedy decode
    step makes no host synchronisation (the last step's on-device argmax
    feeds the next; tables cross from pinned memory without blocking)."""
    from repro_torch.serve import Engine, Request, ServeConfig
    from repro_torch.utils import tree_map

    dev = _cuda_device()
    cfg, cpu_params = _serve_model()
    prompts = [(3, 1, 4, 1, 5), (2, 7, 1), tuple(range(9)), tuple(range(40, 71))]
    runs = {}
    for where in ("cpu", dev):
        params = tree_map(lambda t: t.detach().to(where), cpu_params)
        for scfg in (ServeConfig(block_size=4, num_blocks=32, slots=2, max_len_cap=64,
                                 prefill_chunk=4),
                     ServeConfig(block_size=2, num_blocks=24, slots=2, max_len_cap=48,
                                 prefill_chunk=4)):
            eng = Engine(cfg, params, scfg)
            ids = [eng.submit(Request(tokens=p, max_new=8)) for p in prompts]
            eng.run_until_drained(timeout_s=120)
            eng.alloc.check_invariants()
            assert eng.alloc.num_free == scfg.num_blocks - 1
            runs[(str(where), scfg.num_blocks)] = (
                [eng.result(i).tokens for i in ids], eng.stats["preemptions"])
    for nblocks in (32, 24):
        assert runs[(str(dev), nblocks)] == runs[("cpu", nblocks)], nblocks
    assert runs[("cpu", 24)][1] >= 1 and runs[("cpu", 24)][0] == runs[("cpu", 32)][0]
    params = tree_map(lambda t: t.detach().to(dev), cpu_params)
    eng = Engine(cfg, params, ServeConfig(block_size=4, num_blocks=32, slots=2, max_len_cap=64,
                                          prefill_chunk=8))
    for p in prompts[:2]:
        eng.submit(Request(tokens=p, max_new=12))
    while eng.stats["decode_steps"] < 2:  # prefill, then the first (host-fed) decode step
        eng.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    done = eng.run_until_drained(timeout_s=60)
    assert sorted(len(c.tokens) for c in done) == [12, 12]


# ---------------------------------------------------------------------------
# the model families' layers on the card against the CPU (ROADMAP C.17)
# ---------------------------------------------------------------------------


def _rel_err(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _on(tree, where, grad=False):
    from repro_torch.utils import tree_map

    return tree_map(lambda t: t.detach().to(where).requires_grad_(grad), tree)


def _family_cfg(**kw):
    from repro_torch.configs.base import ModelConfig

    base = dict(name="t", family="moe", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab_size=512, dtype="float32")
    return ModelConfig(**{**base, **kw})


@pytest.mark.cuda
def test_cuda_apply_moe_with_drops_matches_cpu():
    """apply_moe at capacity_factor 0.5 (top-2 of 4: a share of the copies
    dropped) on the card: the output, the aux loss and the gradients of x and
    of every expert leaf (through _Permute's gather adjoint) within
    1e-5·max of the CPU's; _Permute alone, forward and backward, too."""
    from repro_torch.models import moe as moe_lib

    dev = _cuda_device()
    cfg = _family_cfg(n_experts=4, experts_per_token=2, capacity_factor=0.5)
    p = moe_lib.init_moe(torch.Generator().manual_seed(4), cfg, torch.float32)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 64, 64)).astype(np.float32))
    runs = {}
    for where in ("cpu", dev):
        pw, xw = _on(p, where, True), x.to(where).requires_grad_(True)
        y, aux = moe_lib.apply_moe(cfg, pw, xw)
        grads = torch.autograd.grad((y ** 2).sum() + aux, [xw] + [pw[k] for k in sorted(pw)])
        runs[str(where)] = [y, aux] + list(grads)
    assert moe_lib.capacity_for(cfg, 64) == 16  # 128 copies, 64 slots: drops
    for want, got in zip(runs["cpu"], runs[str(dev)]):
        assert _rel_err(got, want) <= 1e-5
    gen = np.random.default_rng(5)
    xs = torch.from_numpy(gen.standard_normal((2, 6, 8)).astype(np.float32))
    idx = torch.from_numpy(np.stack([gen.permutation(6) for _ in range(2)]))
    inv = torch.argsort(idx, dim=1)
    scale = torch.from_numpy((gen.random((2, 6)) > 0.3).astype(np.float32))
    outs = {}
    for where in ("cpu", dev):
        xw = xs.to(where).requires_grad_(True)
        s_fwd, s_bwd = scale.to(where), torch.gather(scale, 1, inv).to(where)
        y = moe_lib._Permute.apply(xw, idx.to(where), inv.to(where), s_fwd, s_bwd)
        (g,) = torch.autograd.grad((y * torch.arange(8.0, device=where)).sum(), [xw])
        outs[str(where)] = (y, g)
    for want, got in zip(outs["cpu"], outs[str(dev)]):
        assert _rel_err(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("max_len", [12, 6])
def test_cuda_chunked_decode_window_matches_cpu(max_len):
    """A chunked-attention layer (chunk 8) decoding through a contiguous cache
    whose length is no multiple of the chunk (12), and one shorter than it
    (6): the card's logits within 1e-5·max of the CPU's at every step."""
    from repro_torch.models import model as TM

    dev = _cuda_device()
    cfg = _family_cfg(family="dense", n_layers=2, attention_chunk=8, full_attn_every=2)
    params = TM.init_params(cfg, seed=2, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, max_len)))
    runs = {}
    for where in ("cpu", dev):
        pw = _on(params, where)
        cache = TM.init_cache(cfg, 2, max_len, device=where)
        with torch.inference_mode():
            out, cache = TM.forward_cached(cfg, pw, {"tokens": tokens[:, :3].to(where)},
                                           cache=cache, cache_pos=0)
            rows = [out]
            for pos in range(3, max_len):
                out, cache = TM.forward_cached(cfg, pw, {"tokens": tokens[:, pos:pos + 1]
                                                         .to(where)}, cache=cache, cache_pos=pos)
                rows.append(out)
        runs[str(where)] = rows
    for want, got in zip(runs["cpu"], runs[str(dev)]):
        assert _rel_err(got[..., :512], want[..., :512]) <= 1e-5


@pytest.mark.cuda
def test_cuda_mrope_positions_match_cpu():
    """A vlm forward with (3, B, S) M-RoPE positions whose rows differ and
    media embeddings, on the card: logits and the loss's gradients within
    1e-5·max of the CPU's."""
    from repro_torch.models import model as TM
    from repro_torch.utils import tree_leaves

    dev = _cuda_device()
    cfg = _family_cfg(family="vlm", n_layers=2, rope_style="mrope", mrope_sections=(2, 3, 3),
                      media_embeds=4)
    params = TM.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    s = np.arange(16)
    pos = np.broadcast_to(np.stack([s // 4, s // 2 % 3, s % 4 + s // 8])[:, None],
                          (3, 2, 16)).astype(np.int32).copy()
    batch = {"tokens": torch.from_numpy(rng.integers(0, 512, (2, 16))),
             "positions": torch.from_numpy(pos),
             "media": torch.from_numpy((0.1 * rng.standard_normal((2, 4, 64))).astype(np.float32))}
    runs = {}
    for where in ("cpu", dev):
        pw = _on(params, where, True)
        bw = {k: v.to(where) for k, v in batch.items()}
        logits = TM.forward(cfg, pw, bw)
        total, _ = TM.loss_fn(cfg, pw, bw)
        runs[str(where)] = [logits[..., :512]] + list(torch.autograd.grad(total,
                                                                          tree_leaves(pw)))
    for want, got in zip(runs["cpu"], runs[str(dev)]):
        assert _rel_err(got, want) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 13, 40])
def test_cuda_apply_ssm_matches_cpu(S):
    """The SSD layer on the card (f32, chunk 8): the chunked scan's output
    and gradients (S = 13 and 40: padded tails; S = 2: shorter than the conv
    history), the prefill's cache and three decode steps, each within
    1e-5·max of the CPU's."""
    from repro_torch.models import ssm as ssm_lib

    dev = _cuda_device()
    cfg = _family_cfg(family="ssm", n_heads=0, n_kv_heads=0, d_ff=0, ssm_state=16,
                      ssm_head_dim=16, ssm_chunk=8)
    p = ssm_lib.init_ssm(torch.Generator().manual_seed(6), cfg, torch.float32)
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.standard_normal((2, S + 3, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, S, 64)).astype(np.float32))
    runs = {}
    for where in ("cpu", dev):
        pw, xw = _on(p, where, True), x[:, :S].to(where).requires_grad_(True)
        y = ssm_lib.apply_ssm(cfg, pw, xw)
        grads = torch.autograd.grad((y * w.to(where)).sum(), [xw] + [pw[k] for k in sorted(pw)])
        cache = ssm_lib.init_ssm_cache(cfg, 2, torch.float32, where)
        with torch.no_grad():
            pd = _on(p, where)
            out = [ssm_lib.apply_ssm(cfg, pd, x[:, :S].to(where), cache)]
            prefill_cache = [cache[k].clone() for k in sorted(cache)]
            out += [ssm_lib.apply_ssm(cfg, pd, x[:, t:t + 1].to(where), cache)
                    for t in range(S, S + 3)]
        runs[str(where)] = [y] + list(grads) + out + prefill_cache + [cache[k] for k in
                                                                      sorted(cache)]
    for want, got in zip(runs["cpu"], runs[str(dev)]):
        assert _rel_err(got, want) <= 1e-5


def _whisper_cfg(**kw):
    import dataclasses

    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config("whisper_small"), dtype="float32", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_layernorm_matches_cpu(dtype):
    """Whisper's LayerNorm at the encoder's input, (8·1500, 768), random
    scale and bias: f32 within 1e-5·max of the CPU's. bf16 x and parameters
    within one bf16 ulp plus 1e-5·max of the CPU's at every element: both
    compute in f32 and round once, and the f32 statistics' summation order
    alone flips a rounding here and there, and moves an output near 0 (where
    out·scale and bias cancel) by more than its own ulp (ROADMAP C.7's
    rule); the same inputs in f32 within 1e-5·max."""
    from repro_torch.models.layers import apply_norm

    dev = _cuda_device()
    cfg = _whisper_cfg()
    rng = np.random.default_rng(31)
    dt = getattr(torch, dtype)
    x = torch.from_numpy((2.0 * rng.standard_normal((8 * 1500, 768)) + 0.5)
                         .astype(np.float32)).to(dt)
    p = {k: torch.from_numpy(rng.standard_normal(768).astype(np.float32)).to(dt)
         for k in ("scale", "bias")}
    want = apply_norm(cfg, p, x)
    got = apply_norm(cfg, _on(p, dev), x.to(dev))
    assert got.dtype == dt
    if dtype == "float32":
        assert _rel_err(got, want) <= 1e-5
        return
    want = want.float()
    ulp = torch.finfo(torch.bfloat16).eps * want.abs()
    assert bool(((got.float().cpu() - want).abs() <= ulp + 1e-5 * want.abs().max()).all())
    pf = {k: v.float() for k, v in p.items()}
    assert _rel_err(apply_norm(cfg, _on(pf, dev), x.to(dev).float()),
                    apply_norm(cfg, pf, x.float())) <= 1e-5


@pytest.mark.cuda
def test_cuda_encoder_attention_matches_cpu():
    """The bidirectional encoder attention at whisper_small's width and S =
    1500 (f32, B = 1): the output and the gradients of x and of every leaf
    within 1e-5·max of the CPU's."""
    from repro_torch.models import attention as attn_lib

    dev = _cuda_device()
    cfg = _whisper_cfg()
    p = attn_lib.init_attention(torch.Generator().manual_seed(32), cfg, torch.float32)
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal((1, 1500, 768)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1, 1500, 768)).astype(np.float32))
    runs = {}
    for where in ("cpu", dev):
        pw, xw = _on(p, where, True), x.to(where).requires_grad_(True)
        y = attn_lib.attend(cfg, pw, xw, angles=None, causal=False)
        grads = torch.autograd.grad((y * w.to(where)).sum(), [xw] + [pw[k] for k in sorted(pw)])
        runs[str(where)] = [y] + list(grads)
    for want, got in zip(runs["cpu"], runs[str(dev)]):
        assert _rel_err(got, want) <= 1e-5


@pytest.mark.cuda
def test_cuda_cross_attention_decode_matches_cpu():
    """One cross-attention decode step at whisper_small's width: a token a
    row (B = 4) against cached cross K/V of 1500 encoder positions, through
    kv_override, within 1e-5·max of the CPU's."""
    from repro_torch.models import attention as attn_lib

    dev = _cuda_device()
    cfg = _whisper_cfg()
    p = attn_lib.init_attention(torch.Generator().manual_seed(33), cfg, torch.float32, cross=True)
    assert "bq" not in p
    rng = np.random.default_rng(33)
    x = torch.from_numpy(rng.standard_normal((4, 1, 768)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((4, 1500, 12, 64)).astype(np.float32))
            for _ in range(2))
    with torch.inference_mode():
        want = attn_lib.attend(cfg, p, x, angles=None, kv_override=(k, v))
        got = attn_lib.attend(cfg, _on(p, dev), x.to(dev), angles=None,
                              kv_override=(k.to(dev), v.to(dev)))
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.cuda
def test_cuda_audio_prefill_decode_matches_cpu():
    """The audio family's cached path on a narrow config (2 + 2 layers,
    d_model 64, 16 frames), dec_pos and frames drawn: a 5-token prefill with
    frames (the cross K/V written into the cache) and three decode steps
    without them, the logits and the cache within 1e-5·max of the CPU's."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as TM

    dev = _cuda_device()
    cfg = get_config("whisper_small", smoke=True)
    params = TM.init_params(cfg, seed=34, device="cpu")
    rng = np.random.default_rng(34)
    with torch.no_grad():
        params["dec_pos"].copy_(torch.from_numpy(
            (0.02 * rng.standard_normal((8192, 64))).astype(np.float32)))
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 8)))
    frames = torch.from_numpy((0.1 * rng.standard_normal((2, 16, 64))).astype(np.float32))
    runs = {}
    for where in ("cpu", dev):
        pw = _on(params, where)
        cache = TM.init_cache(cfg, 2, 8, device=where)
        with torch.inference_mode():
            out, _ = TM.forward_cached(cfg, pw, {"tokens": tokens[:, :5].to(where),
                                                 "enc_frames": frames.to(where)},
                                       cache=cache, cache_pos=0)
            rows = [out]
            for pos in range(5, 8):
                out, _ = TM.forward_cached(cfg, pw, {"tokens": tokens[:, pos:pos + 1].to(where)},
                                           cache=cache, cache_pos=pos)
                rows.append(out)
        runs[str(where)] = [r[..., :512] for r in rows] + [cache["cross_k"], cache["cross_v"],
                                                          cache["self"]["k"], cache["self"]["v"]]
    for want, got in zip(runs["cpu"], runs[str(dev)]):
        assert _rel_err(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# GaLore-ZeRO's rank blocks, and a gloo world of 2 on one card
# ---------------------------------------------------------------------------

# (shape, side): the llama_7b leaves at rank 128 split over 2 ranks (the
# fp32 and int8-moment kernels run on blocks of 64) ...
BLOCK_CASES = [((2, 4096, 64, 4096), "left"), ((2, 4096, 64, 11008), "left"),
               ((2, 11008, 64, 4096), "right")]
# ... and at rank 1024 (the tiled projections run on blocks of 512)
BLOCK_PROJECT_SHAPES = [(2, 4096, 512, 4096), (2, 4096, 512, 11008)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: f"{c[1]}{c[0]}")
def test_cuda_fp32_kernel_at_rank_blocks(case):
    """B1/B2 on a rank block of 64 (ZeRO-1 at r = 128, n_dp 2), G bf16,
    against the plain version: G̃, M' and V' within 1e-5·max|want| +
    1e-5·|want|."""
    dev = _cuda_device()
    shape, side = case
    P, G, M, V = (torch.from_numpy(a).to(dev) for a in fused_inputs(shape, side))
    G = G.to(torch.bfloat16)
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    name = "galore_fused_adam_step" + ("_right" if side == "right" else "")
    fn, plain = getattr(tk, name), getattr(tk, name + "_plain")
    want = plain(P, G, M, V, count, alpha=0.25)
    before = fn.launches
    got = fn(P, G, M.clone(), V.clone(), count, alpha=0.25)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for what, a, b in zip(("G̃", "M'", "V'"), got, want):
        assert _within(a, b), f"{case} {what}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: f"{c[1]}{c[0]}")
@pytest.mark.parametrize("p_int4", [False, True])
def test_cuda_adam8_kernel_at_rank_blocks(case, p_int4):
    """B3-int8 on a rank block of 64, G bf16, P f32 or a block of the packed
    int4 P (its codes' and scales' columns, a bitwise slice): G̃ and scales
    within 1e-5·max|want| + 1e-5·|want|, codes at most 1 apart."""
    dev = _cuda_device()
    shape, side = case
    P, moments, G = _adam8_card_inputs(shape, side, dev, seed=sum(shape) + 1)
    G = G.to(torch.bfloat16)
    if p_int4:
        full = codec.quant4_axis_state(torch.cat([P, P], dim=-1))  # a rank-128 P's first block
        P = {k: v[..., :shape[-2]].contiguous() for k, v in full.items()}
    count = torch.tensor(7, dtype=torch.int32, device=dev)
    name = "galore_fused_adam8_step" + ("_right" if side == "right" else "")
    fn, plain = getattr(tk, name), getattr(tk, name + "_plain")
    want = plain(P, G, *moments, count, alpha=0.25)
    before = fn.launches
    got = fn(P, G, *[x.clone() for x in moments], count, alpha=0.25)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert _within(got[0], want[0]), case
    for what, a, b in zip(["mq", "ms", "vq", "vs"], got[1:], want[1:]):
        if b.dtype == torch.uint8:
            assert int((a.int() - b.int()).abs().max()) <= 1, f"{case} {what}"
        else:
            assert _within(a, b), f"{case} {what}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BLOCK_PROJECT_SHAPES)
@pytest.mark.parametrize("transpose", [False, True])
def test_cuda_project_kernels_at_rank_blocks(shape, transpose):
    """B4 and B5 on a rank block of 512 (ZeRO-1 at r = 1024, n_dp 2), G bf16
    stored either way, G̃ written either way: within 1e-5·max|want| +
    1e-5·|want|."""
    dev = _cuda_device()
    P, G, N = _card_proj_inputs(shape, dev)
    G = G.to(torch.bfloat16)
    if transpose:
        G = G.transpose(-1, -2).contiguous()
    got = tp.galore_project(P, G, transpose_g=transpose)
    back = tp.galore_project_back(P, N, 0.25, transpose_out=transpose)
    torch.cuda.synchronize()
    assert _within(got, tp.galore_project_plain(P, G, transpose))
    assert _within(back, tp.galore_project_back_plain(P, N, 0.25, transpose))


@pytest.mark.cuda
def test_cuda_world_collectives_in_a_gloo_world_of_two(tmp_path):
    """distributed/world.py's collectives on CUDA tensors, two ranks sharing
    cuda:0 over gloo (NCCL refuses two ranks on one device): sum, mean
    (f32, cast back to bf16), all-gather, reduce-scatter and broadcast equal
    the host computation, the results stay on the card, and every call was
    staged through host memory."""
    _cuda_device()
    from torch_world import collectives_check, run_world

    out = run_world(collectives_check, 2, tmp_path, "cuda", device="cuda")
    for k, r in enumerate(out):
        assert r["devices"] == {"cuda"}, r["devices"]
        assert r["staged"] == 5, r["staged"]
        for name, (got, want) in r["results"].items():
            assert torch.equal(got, want), (k, name)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["none", "scores", "names", "full"])
def test_cuda_remat_policy_matches_cpu(policy):
    """llama_60m smoke (f32) under each remat policy on the card: the loss
    and the gradient of every leaf within 1e-5·max of the same policy's CPU
    run, and the card's own "none" bit for bit where the policy recomputes
    on the card (no atomics in the dense path)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as TM
    from repro_torch.utils import tree_leaves

    dev = _cuda_device()
    cfg = dataclasses.replace(get_config("llama_60m", smoke=True), remat=policy)
    params = TM.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40)))
    runs = {}
    for where, c in (("cpu", cfg), (dev, cfg), ("none", dataclasses.replace(cfg, remat="none"))):
        at = dev if where == "none" else where
        pw = _on(params, at, True)
        total, _ = TM.loss_fn(c, pw, {"tokens": tokens.to(at)})
        runs[str(where)] = [total] + list(torch.autograd.grad(total, tree_leaves(pw)))
    for want, got in zip(runs["cpu"], runs[str(dev)]):
        assert _rel_err(got, want) <= 1e-5
    for want, got in zip(runs["none"], runs[str(dev)]):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_names_equals_none_bitwise_at_llama_7b_width():
    """One llama_7b-width layer (bf16, 1 × 256) on the card: the loss and every
    gradient leaf under remat "names" — its backward replaying only what it
    reads (ROADMAP C.31) — equal "none"'s bit for bit."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as TM
    from repro_torch.utils import tree_leaves

    dev = _cuda_device()
    cfg = dataclasses.replace(get_config("llama_7b"), n_layers=1)
    params = TM.init_params(cfg, seed=0, device=dev)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 256)))
    runs = {}
    for policy in ("none", "names"):
        total, _ = TM.loss_fn(dataclasses.replace(cfg, remat=policy), params,
                              {"tokens": tokens.to(dev)})
        runs[policy] = [total.detach()] + list(torch.autograd.grad(total, tree_leaves(params)))
    for got, want in zip(runs["names"], runs["none"]):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_async_randomized_driver_records_refresh_and_wait(tmp_path, monkeypatch):
    """The async double buffer with the randomized projector (staggered,
    moments re-projected, as chip_smoke.py's async-rand) on the card:
    every dispatch's history entry has the thread's refresh_s and the main
    thread's wait_s at the swap, and the losses are finite."""
    import math

    import repro_torch.launch.train as launcher
    from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config

    _cuda_device()
    drivers = []

    class Kept(launcher.AsyncRefreshDriver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            drivers.append(self)

    monkeypatch.setattr(launcher, "AsyncRefreshDriver", Kept)
    g = GaLoreConfig(rank=8, update_freq=4, refresh_stagger=True, reproject_moments=True,
                     projector="randomized")
    tc = TrainConfig(galore=g, galore_refresh_async=True, total_steps=6, warmup_steps=1)
    losses = []
    launcher.train_loop(launcher.RunConfig(steps=6, batch_per_host=2, seq_len=32, log_every=100,
                                           ckpt_every=0, ckpt_dir=str(tmp_path), device="cuda"),
                        tc, cfg=get_config("llama_60m", smoke=True),
                        on_step=lambda s, m: losses.append(float(m["loss"])))
    assert all(map(math.isfinite, losses)) and len(losses) == 6
    hist = drivers[-1].history
    assert hist and all(h["refresh_s"] > 0 and h["wait_s"] >= 0 for h in hist), hist


@pytest.mark.cuda
def test_cuda_mesh_of_one_is_the_unsharded_step_with_the_kernels(tmp_path):
    """make_train_step with the pod's rules on a 1 × 1 mesh (a world of one
    rank, NCCL) on the card: the fused GaLore step's losses and params bit
    for bit the unsharded step's, from the same params and batches, and B1
    and B2 launched as often in both."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config
    from repro_torch.distributed import step as dstep
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models.model import init_params
    from repro_torch.utils import tree_leaves

    _cuda_device()
    cfg = dataclasses.replace(get_config("llama_60m"), n_layers=2)
    tc = TrainConfig(galore=GaLoreConfig(rank=64, update_freq=4, scale=0.25),
                     galore_fused_adam=True, lr=1e-3, total_steps=3, warmup_steps=1)
    gen = torch.Generator(device="cuda").manual_seed(3)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 128), generator=gen,
                                        device="cuda")} for _ in range(3)]
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    runs = []
    try:
        rules = lmesh.default_rules(lmesh.make_sim_mesh(1, 1, device_type="cuda"))
        for r in (None, rules):
            params = init_params(cfg, seed=0, device="cuda")
            step, opt = dstep.make_train_step(cfg, tc, r)
            state = opt.init(params)
            if r is not None:
                state = dstep.shard_opt_state(cfg, tc, state, params, r)
                params = dstep.shard_params(cfg, params, r)
            ops.reset_launch_counts()
            losses = []
            for b in batches:
                params, state, m = step(params, state, b)
                losses.append(m["loss"].clone())
            runs.append((losses, [p.full_tensor() if hasattr(p, "full_tensor") else p
                                  for p in tree_leaves(params)],
                         (tk.galore_fused_adam_step.launches,
                          tk.galore_fused_adam_step_right.launches)))
    finally:
        dist.destroy_process_group()
    (l0, p0, n0), (l1, p1, n1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert n0 == n1 and min(n0) > 0


@pytest.mark.cuda
def test_cuda_fake_rank_memory_matches_the_sharded_dry_run():
    """llama_7b's train_4k cell at 2 of 32 layers (remat full, 2
    microbatches) as rank 0 of
    a fake 16 × 16 world on the card: max_memory_allocated within 5 % of the
    sharded dry run's peak, and the collectives by kind as many as it
    counted."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as lmesh

    _cuda_device()
    over = {"n_layers": 2, "remat": "full"}
    rec = dryrun.run_mesh_cell("llama_7b", "train_4k", microbatch=2, overrides=over)
    cfg = dataclasses.replace(get_config("llama_7b"), **over)
    with dryrun.fake_world(256):
        rules = lmesh.rules_variant(lmesh.make_production_mesh(device_type="cuda"), "baseline")
        run = dryrun.run_fake_rank(cfg, dryrun.default_train_config(cfg, microbatch=2),
                                   "train_4k", rules)
    assert abs(rec["memory"]["peak_bytes_per_device"] / run["peak_bytes"] - 1) < 0.05
    assert run["collectives"].stats().count_by_kind == rec["collective_schedule"]["count_by_kind"]
