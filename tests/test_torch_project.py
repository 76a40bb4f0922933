"""The port's tiled projections (B4, B5), the fp32 fused step's routing and
RMSNorm (B6) against the JAX package on the same inputs: the plain versions
against the Pallas kernels in interpret mode, the port's copy of the
reference's ``fits_vmem`` against the reference's, the composite leaf step
(tiled projections around a plain Adam update) against JAX's Pallas-interpret
fallback, which route the dispatch takes, and a 20-step trajectory through
the composite route. The kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticC4 as JSyntheticC4  # noqa: E402
from repro.distributed.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.kernels import galore_fused as jgf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.quant import codec as jcodec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.kernels import galore_fused as tk  # noqa: E402
from repro_torch.kernels import galore_project as tp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rmsnorm as tr  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from test_torch_cuda import PROJECT_SHAPES, fused_inputs, proj_inputs  # noqa: E402
from test_torch_quant import _assert_close  # noqa: E402
from test_torch_train import _Bridged  # noqa: E402

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
# 3. the composite leaf step against JAX's Pallas-interpret fallback
# ---------------------------------------------------------------------------

# (shape, side) whose P fails fits_vmem: P (2, 2048, 1024) on either side
COMPOSITE_CASES = [((2, 2048, 1024, 96), "left"), ((2, 96, 1024, 2048), "right")]


def _p_arg(P, p_int4):
    """The projector as JAX and the port each take it: f32, or the packed int4
    qstate made by the JAX codec (the two codecs agree bit for bit)."""
    if not p_int4:
        return jnp.asarray(P), torch.from_numpy(P)
    jP = jcodec.quant4_axis_state(jnp.asarray(P))
    return jP, {k: torch.from_numpy(np.array(v)) for k, v in jP.items()}


@pytest.mark.parametrize("shape,side", COMPOSITE_CASES)
@pytest.mark.parametrize("p_int4", [False, True])
def test_composite_step_matches_pallas_interpret(shape, side, p_int4):
    """ops.galore_fused_adam_step[_right] at a shape that fails fits_vmem
    (the port's galore_project → Adam → galore_project_back, on swapped views
    on the right) == JAX's ops.galore_fused_adam_step[_right](…, use_pallas=
    True, interpret=True), which takes its B4/B5 fallback there: G̃, M' and V'
    within 1e-5·max(max|want|, 1e-3), moments from six earlier steps."""
    assert not tk.fits_vmem(2048, 1024, 96, 4)  # kept 2048, rank 1024, swept 96, G f32
    P, G, M, V = fused_inputs(shape, side)
    jP, tP = _p_arg(P, p_int4)
    right = side == "right"
    jfn = jops.galore_fused_adam_step_right if right else jops.galore_fused_adam_step
    want = jfn(jP, jnp.asarray(G), jnp.asarray(M), jnp.asarray(V), jnp.int32(7), alpha=0.25,
               use_pallas=True, interpret=True)
    tfn = ops.galore_fused_adam_step_right if right else ops.galore_fused_adam_step
    Mt, Vt = torch.from_numpy(M.copy()), torch.from_numpy(V.copy())
    got = tfn(tP, torch.from_numpy(G), Mt, Vt, torch.tensor(7, dtype=torch.int32), alpha=0.25)
    assert got[1] is Mt and got[2] is Vt  # moments updated in place, as the fused wrapper does
    for name, a, b in zip(["update", "m", "v"], got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * max(float(np.abs(b).max()), 1e-3),
                                   err_msg=f"{side} {shape} int4 P {p_int4} {name}")


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("fits", [True, False])
def test_dispatch_takes_the_reference_route(monkeypatch, side, fits):
    """A spy on both routes: where fits_vmem holds the fused wrapper runs and
    the tiled projections do not; where it fails, the reverse (one
    galore_project and one galore_project_back call)."""
    calls = {"fused": 0, "project": 0, "back": 0}

    def spy(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    right = side == "right"
    name = "galore_fused_adam_step_right" if right else "galore_fused_adam_step"
    monkeypatch.setattr(tk, name, spy("fused", getattr(tk, name)))
    monkeypatch.setattr(ops, "galore_project", spy("project", tp.galore_project))
    monkeypatch.setattr(ops, "galore_project_back", spy("back", tp.galore_project_back))
    shape = (64, 16, 48) if fits else {"left": (2048, 1024, 96), "right": (96, 1024, 2048)}[side]
    P, G, M, V = (torch.from_numpy(a) for a in fused_inputs(shape, side))
    getattr(ops, name)(P, G, M, V, torch.tensor(1, dtype=torch.int32))
    want = {"fused": 1, "project": 0, "back": 0} if fits else {"fused": 0, "project": 1, "back": 1}
    assert calls == want


def test_composite_route_trajectory_matches_jax(monkeypatch, tmp_path):
    """20 steps of --galore-fused on the llama_60m smoke config (rank 16,
    T 10) with every leaf sent through the composite route (fits_vmem made to
    fail), against the JAX package's fused run: per-step losses within 5e-2,
    and the tiled projections called once per GaLore leaf and step."""
    calls = []
    monkeypatch.setattr(ops, "fits_vmem", lambda *a, **k: False)
    monkeypatch.setattr(ops, "galore_project",
                        lambda *a, **k: calls.append(1) or tp.galore_project(*a, **k))
    steps, batch, seq = 20, 4, 64
    jcfg = jax_get_config("llama_60m", smoke=True)
    jtc = JTrainConfig(optimizer="adamw", galore=JGaLoreConfig(rank=16, update_freq=10),
                       galore_fused_adam=True, total_steps=steps, warmup_steps=2)
    jdata = JSyntheticC4(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=seq,
                                     batch_per_host=batch))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    step_fn, jopt = jax_make_train_step(jcfg, jtc)
    step_fn = jax.jit(step_fn)
    jstate = jopt.init(jparams)
    want = []
    for s in range(steps):
        jparams, jstate, metrics = step_fn(jparams, jstate, jdata.batch(s))
        want.append(float(metrics["loss"]))
    got = []
    tc = TrainConfig(optimizer="adamw", galore=GaLoreConfig(rank=16, update_freq=10),
                     galore_fused_adam=True, total_steps=steps, warmup_steps=2)
    train_loop(RunConfig(steps=steps, batch_per_host=batch, seq_len=seq, log_every=steps,
                         ckpt_dir=str(tmp_path), device="cpu"),
               tc, cfg=get_config("llama_60m", smoke=True), params=tparams,
               data=_Bridged(jdata), on_step=lambda s, m: got.append(float(m["loss"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
    assert len(calls) == 7 * steps  # wq wk wv wo gate up down, every step


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
