"""The fp32 fused step's composite route (the port's galore_project → Adam →
galore_project_back, taken where the reference's ``fits_vmem`` fails)
against the JAX package: the leaf step against JAX's Pallas-interpret
fallback, which route the dispatch takes, and a 20-step trajectory with every
leaf forced through the composite route."""
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
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.quant import codec as jcodec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.kernels import galore_fused as tk  # noqa: E402
from repro_torch.kernels import galore_project as tp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from test_torch_cuda import fused_inputs  # noqa: E402
from test_torch_train import _Bridged  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

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
