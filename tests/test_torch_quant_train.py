"""The port's 8-bit GaLore (int8 moments, packed int4 projectors) in the
training path, against the JAX package: one update at a fixed projector, a
20-step trajectory, the state layout and bytes, the bridge, and the CLI.
(The codecs and the leaf step are in tests/test_torch_quant.py.)"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.galore import galore as jax_galore  # noqa: E402
from repro.core.galore import galore_state_bytes as jax_galore_state_bytes  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticC4 as JSyntheticC4  # noqa: E402
from repro.distributed.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adam import scale_by_adam as jax_scale_by_adam  # noqa: E402
from repro.quant import QuantPolicy as JQuantPolicy  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    galore_state_from_numpy,
    galore_state_to_numpy,
    params_from_numpy,
)
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.galore import galore, galore_state_bytes  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.quant import QuantPolicy, codec  # noqa: E402
from repro_torch.utils import flatten_up_to, tree_leaves_with_path, tree_map  # noqa: E402
from test_torch_cuda import assert_codes_close  # noqa: E402
from test_torch_quant import HP, _assert_bitwise, _assert_close  # noqa: E402
from test_torch_train import _Bridged  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

POLICY = dict(moments="int8", projectors="int4")


def _smoke_params():
    cfg = jax_get_config("llama_60m", smoke=True)
    return jax.tree_util.tree_map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))


def _by_path(jtree):
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    return {".".join(str(k.key) for k in path): np.asarray(x) for path, x in flat}


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)


# ---------------------------------------------------------------------------
# the update, the trajectory, the state
# ---------------------------------------------------------------------------


def _jax_opt(fused, **cfg):
    jcfg = JGaLoreConfig(quant=JQuantPolicy(**POLICY), **cfg)
    return jax_galore(jax_scale_by_adam(), jcfg, fused_adam=fused, **HP)


@pytest.mark.parametrize("fused", [True, False])
def test_int8_update_at_fixed_projector_matches_jax(fused):
    """Step 0 refreshes P (int4) in JAX; the 8-bit state is bridged over and
    the step-1 update (no refresh, T = 10) runs on both sides. The smoke
    params cover ragged int4 kept dims (64 → 128), a ragged moment block
    (n = 64), a right leaf, the int8 embedding and fp32 norms."""
    params = _smoke_params()
    jopt = _jax_opt(fused, rank=16, update_freq=10, scale=0.25)
    jupdate = jax.jit(jopt.update)
    jstate = jopt.init(params)
    _, jstate = jupdate(_grads(params, 1), jstate, params)
    g2 = _grads(params, 2)
    state = galore_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    jupd, jstate = jupdate(g2, jstate, params)

    opt = galore(GaLoreConfig(rank=16, update_freq=10, scale=0.25, quant=QuantPolicy(**POLICY)),
                 fused=fused, **HP)
    tparams = params_from_numpy(params, "cpu")
    upd, state = opt.update(tree_map(torch.from_numpy, g2), state, tparams)

    jupd = _by_path(jupd)
    for path, u in tree_leaves_with_path(upd):
        _assert_close(u.numpy(), jupd[path], path, tol=2e-5)
    for name in ("m", "v"):
        jflat = _by_path(jstate["inner"][name])
        for path, x in tree_leaves_with_path(state["inner"][name]):
            if x.dtype == torch.uint8:
                assert_codes_close(x, jflat[path], f"{name} {path}")
            else:
                _assert_close(x.numpy(), jflat[path], f"{name} {path}", tol=2e-5)
    kinds = {codec.is_qstate(x) for x in flatten_up_to(tparams, state["inner"]["m"])}
    assert kinds == {True, False}  # int8 leaves beside fp32 norms under the size floor
    assert state["step"] == 2 and int(state["inner"]["count"]) == 2


@pytest.mark.parametrize("fused", [True, False])
def test_int8_trajectory_matches_jax(fused, tmp_path):
    """20 steps of 8-bit GaLore (rank 16, T 10, int8 + int4) at the
    llama_60m smoke config: per-step losses within 5e-2 of the JAX run."""
    steps, batch, seq = 20, 4, 64
    jcfg = jax_get_config("llama_60m", smoke=True)
    jtc = JTrainConfig(optimizer="adamw", galore=JGaLoreConfig(
        rank=16, update_freq=10, quant=JQuantPolicy(**POLICY)),
        galore_fused_adam=fused, total_steps=steps, warmup_steps=2)
    jdata = JSyntheticC4(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=seq, batch_per_host=batch))
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
    tc = TrainConfig(optimizer="adamw", galore=GaLoreConfig(
        rank=16, update_freq=10, quant=QuantPolicy(**POLICY)),
        galore_fused_adam=fused, total_steps=steps, warmup_steps=2)
    train_loop(RunConfig(steps=steps, batch_per_host=batch, seq_len=seq, log_every=steps,
                         ckpt_dir=str(tmp_path), device="cpu"),
               tc, cfg=get_config("llama_60m", smoke=True), params=tparams, data=_Bridged(jdata),
               on_step=lambda s, m: got.append(float(m["loss"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
    assert want[-1] < want[0]


def test_int8_state_layout_and_bytes_match_jax():
    """galore.init under the 8-bit policy has the JAX state's paths, shapes
    and dtypes leaf for leaf (the JAX PRNG key aside), and the analytic
    state bytes agree."""
    params = _smoke_params()
    jstate = _jax_opt(False, rank=16).init(params)
    cfg = GaLoreConfig(rank=16, quant=QuantPolicy(**POLICY))
    state = galore(cfg, **HP).init(params_from_numpy(params, "cpu"))
    for group in ("proj", "inner"):
        want = {p: (x.shape, x.dtype.name) for p, x in _by_path(jstate[group]).items()}
        got = {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
               for p, x in tree_leaves_with_path(state[group])}
        assert got == want, group
    assert any(p.endswith(".q") for p in _by_path(jstate["proj"]))
    assert galore_state_bytes(params, cfg) == jax_galore_state_bytes(params, JGaLoreConfig(
        rank=16, quant=JQuantPolicy(**POLICY)))


def test_bridge_round_trips_jax_8bit_state():
    """A JAX 8-bit GaLore state (int8 moments, int4 projectors, after one
    refresh) crosses to the port and back bit for bit."""
    params = _smoke_params()
    jopt = _jax_opt(True, rank=16, update_freq=10)
    _, jstate = jax.jit(jopt.update)(_grads(params, 1), jopt.init(params), params)
    jnp_state = jax.tree_util.tree_map(np.asarray, jstate)
    state = galore_state_from_numpy(jnp_state, "cpu")
    assert state["inner"]["m"]["blocks"]["ffn"]["up"]["q"].dtype == torch.uint8
    back = galore_state_to_numpy(state)
    want = _by_path(jnp_state)
    got = _by_path(back)
    assert sorted(got) == sorted(want)
    for path in want:
        _assert_bitwise(got[path], want[path], path)


# ---------------------------------------------------------------------------
# 7. the CLI
# ---------------------------------------------------------------------------

_CLI = ["--steps", "3", "--seq", "32", "--batch", "2", "--galore-rank", "16", "--galore-t", "2",
        "--galore-fused", "--quant-moments", "int8", "--quant-proj", "int4", "--log-every", "1"]


def test_cli_trains_8bit_on_cpu_and_refuses_without_gpu(tmp_path, capsys, monkeypatch):
    rc, out, err = _main_in_process(_CLI + ["--device", "cpu", "--ckpt-dir", str(tmp_path)],
                                    capsys)
    assert rc == 0, err
    losses = [float(line.split()[4]) for line in out.splitlines()
              if line.startswith("[train] step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    rc, _, err = _main_in_process(_CLI + ["--ckpt-dir", str(tmp_path / "refused")], capsys,
                                  monkeypatch)
    assert rc == 2 and "no CUDA device" in err

def _main_in_process(argv, capsys, monkeypatch=None):
    """The launcher's main in process (a subprocess would spend its time
    importing torch): (exit code, stdout, stderr). With `monkeypatch` the
    process sees no CUDA device, as a CPU-only host."""
    from repro_torch.launch import train as launcher

    if monkeypatch is not None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        launcher.main(argv)
        rc = 0
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err
