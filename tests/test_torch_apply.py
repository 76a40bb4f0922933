"""The port's W-in-place GaLore step (``galore_fused_apply``) against the JAX
package: the four apply leaf steps against the Pallas epilogue in interpret
mode, the apply train step against the port's own emit path + chain, a
20-step trajectory against the JAX apply step, the state swap between the
two paths, and the refusals of the launcher and of make_train_step."""
import dataclasses

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
from repro.quant import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.quant import codec as jcodec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.galore import _managed_adam_update, _read_proj_tree, galore  # noqa: E402
from repro_torch.core.subspace import SubspaceManager  # noqa: E402
from repro_torch.distributed.step import make_train_step  # noqa: E402
from repro_torch.kernels import galore_fused as tk  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402
from repro_torch.utils import tree_leaves_with_path, tree_map  # noqa: E402
from test_torch_cuda import (  # noqa: E402
    adam8_inputs,
    assert_codes_close,
    assert_weight_close,
    fused_inputs,
)
from test_torch_quant import _assert_close  # noqa: E402
from test_torch_train import _Bridged  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

# (shape, side): ragged n, a right leaf with ragged m, a stacked leaf
CASES = [((72, 16, 130), "left"), ((130, 16, 72), "right"), ((3, 72, 16, 130), "left")]
ETA, WD, ALPHA, COUNT = np.float32(-1e-2), 0.1, 0.25, 7
POLICY = dict(moments="int8", projectors="int4")


def _weight(shape, seed):
    lead, (m, _, n) = tuple(shape[:-3]), shape[-3:]
    return (np.random.default_rng(seed).standard_normal(lead + (m, n)) * 0.02).astype(np.float32)


def _jax_w(W):
    # a copy: an f32 W's numpy view shares its memory, JAX may take that
    # buffer without copying and runs later, and the port's step writes W in
    # place meanwhile
    return jnp.asarray(W.float().numpy().copy()).astype(
        jnp.bfloat16 if W.dtype == torch.bfloat16 else jnp.float32)


def _jax_g(G, w_dtype):
    return jnp.asarray(G).astype(jnp.bfloat16 if w_dtype == torch.bfloat16 else jnp.float32)


# ---------------------------------------------------------------------------
# 1. the four apply leaf steps against the Pallas epilogue (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,side", CASES)
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_apply_plain_matches_pallas_interpret(shape, side, w_dtype):
    wdt = getattr(torch, w_dtype)
    P, G, M, V = fused_inputs(shape, side)
    W = torch.from_numpy(_weight(shape, 3)).to(wdt)
    w0 = W.clone()
    right = side == "right"
    jfn = jops.galore_fused_adam_apply_step_right if right else jops.galore_fused_adam_apply_step
    want = jfn(jnp.asarray(P), _jax_g(G, wdt), _jax_w(W), jnp.asarray(M), jnp.asarray(V),
               jnp.int32(COUNT), alpha=ALPHA, eta=jnp.float32(ETA), wd=WD, use_pallas=True,
               interpret=True)
    tfn = tk.galore_fused_adam_apply_step_right if right else tk.galore_fused_adam_apply_step
    Mt, Vt = torch.from_numpy(M.copy()), torch.from_numpy(V.copy())
    tk.reset_launch_counts()
    got = tfn(torch.from_numpy(P), torch.from_numpy(G).to(wdt), W, Mt, Vt,
              torch.tensor(COUNT, dtype=torch.int32), alpha=ALPHA, eta=torch.tensor(ETA), wd=WD)
    assert got[0] is W and got[1] is Mt and got[2] is Vt  # all updated in place
    assert W.dtype == wdt and all(fn.launches == 0 for fn in tk.WRAPPERS)
    tag = f"{side} {shape} W {w_dtype}"
    assert_weight_close(W, np.asarray(want[0]).astype(np.float32), w0, f"{tag} W",
                        tol=2e-5)
    _assert_close(Mt, want[1], f"{tag} m")
    _assert_close(Vt, want[2], f"{tag} v")


@pytest.mark.parametrize("shape,side", CASES)
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_apply_int4p_plain_matches_pallas_interpret(shape, side, w_dtype):
    """The fp32-moment apply step with P as the packed int4 qstate against the
    Pallas epilogue with quant_p and apply_w (interpret mode): f32 W' - W
    within 2e-5·max, bf16 W' within one ulp, M' and V' within 1e-5."""
    wdt = getattr(torch, w_dtype)
    P, G, M, V = fused_inputs(shape, side)
    jP = jcodec.quant4_axis_state(jnp.asarray(P))
    tP = {k: torch.from_numpy(np.array(v)) for k, v in jP.items()}
    W = torch.from_numpy(_weight(shape, 6)).to(wdt)
    w0 = W.clone()
    right = side == "right"
    jfn = jops.galore_fused_adam_apply_step_right if right else jops.galore_fused_adam_apply_step
    want = jfn(jP, _jax_g(G, wdt), _jax_w(W), jnp.asarray(M), jnp.asarray(V), jnp.int32(COUNT),
               alpha=ALPHA, eta=jnp.float32(ETA), wd=WD, use_pallas=True, interpret=True)
    tfn = tk.galore_fused_adam_apply_step_right if right else tk.galore_fused_adam_apply_step
    Mt, Vt = torch.from_numpy(M.copy()), torch.from_numpy(V.copy())
    tk.reset_launch_counts()
    got = tfn(tP, torch.from_numpy(G).to(wdt), W, Mt, Vt, torch.tensor(COUNT, dtype=torch.int32),
              alpha=ALPHA, eta=torch.tensor(ETA), wd=WD)
    assert got[0] is W and got[1] is Mt and got[2] is Vt  # all updated in place
    assert tfn.launches == tfn.launches_int4 == 0  # the plain version ran
    tag = f"{side} {shape} W {w_dtype} int4 P"
    assert_weight_close(W, np.asarray(want[0]).astype(np.float32), w0, f"{tag} W", tol=2e-5)
    _assert_close(Mt, want[1], f"{tag} m")
    _assert_close(Vt, want[2], f"{tag} v")


@pytest.mark.parametrize("shape,side", CASES)
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p_int4", [False, True])
def test_adam8_apply_plain_matches_pallas_interpret(shape, side, w_dtype, p_int4):
    wdt = getattr(torch, w_dtype)
    P, G, moments = adam8_inputs(shape, side)
    if p_int4:
        jP = jcodec.quant4_axis_state(jnp.asarray(P))
        tP = {k: torch.from_numpy(np.array(v)) for k, v in jP.items()}
    else:
        jP, tP = jnp.asarray(P), torch.from_numpy(P)
    W = torch.from_numpy(_weight(shape, 4)).to(wdt)
    w0 = W.clone()
    right = side == "right"
    jfn = (jops.galore_fused_adam8_apply_step_right if right
           else jops.galore_fused_adam8_apply_step)
    want = jfn(jP, _jax_g(G, wdt), _jax_w(W), *map(jnp.asarray, moments), jnp.int32(COUNT),
               alpha=ALPHA, eta=jnp.float32(ETA), wd=WD, use_pallas=True, interpret=True)
    tfn = tk.galore_fused_adam8_apply_step_right if right else tk.galore_fused_adam8_apply_step
    mine = [torch.from_numpy(t.copy()) for t in moments]
    got = tfn(tP, torch.from_numpy(G).to(wdt), W, *mine, torch.tensor(COUNT, dtype=torch.int32),
              alpha=ALPHA, eta=torch.tensor(ETA), wd=WD)
    assert got[0] is W and all(a is b for a, b in zip(got[1:], mine))
    tag = f"{side} {shape} W {w_dtype} int4 P {p_int4}"
    assert_weight_close(W, np.asarray(want[0]).astype(np.float32), w0, f"{tag} W",
                        tol=2e-5)
    for name, a, b in zip(["mq", "ms", "vq", "vs"], got[1:], want[1:]):
        if a.dtype == torch.uint8:
            assert_codes_close(a, b, f"{tag} {name}")
        else:
            _assert_close(a, b, f"{tag} {name}")


# ---------------------------------------------------------------------------
# 2. the apply train step against the emit path + chain, and the state swap
# ---------------------------------------------------------------------------


def _tcs(quant):
    gal = GaLoreConfig(rank=8, update_freq=2, quant=QuantPolicy(**POLICY) if quant else
                       QuantPolicy())
    emit = TrainConfig(optimizer="adamw", lr=1e-2, weight_decay=0.01, galore=gal,
                       galore_fused_adam=True)
    return emit, dataclasses.replace(emit, galore_fused_apply=True)


def _fresh(params):
    return tree_map(lambda p: p.detach().clone().requires_grad_(True), params)


def _smoke():
    cfg = get_config("llama_60m", smoke=True)
    params = TM.init_params(cfg, seed=0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32))
    return cfg, params, {"tokens": torch.from_numpy(tokens)}


def _shapes(tree):
    return [(path, tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else (path, type(x))
            for path, x in tree_leaves_with_path({str(i): s for i, s in enumerate(tree)})]


def _assert_params_close(got, want):
    want = dict(tree_leaves_with_path(want))
    for path, x in tree_leaves_with_path(got):
        np.testing.assert_allclose(x.detach().float().numpy(), want[path].detach().float().numpy(),
                                   rtol=2e-5, atol=2e-6, err_msg=path)


@pytest.mark.parametrize("quant", [False, True])
def test_apply_train_step_matches_emit_chain(quant):
    """tc.galore_fused_apply (W updated inside the leaf step) follows the
    emit path + chain, the numerics oracle: every parameter within rtol
    2e-5, atol 2e-6 after 5 steps (rank 8, T 2: two refreshes)."""
    cfg, params, batch = _smoke()
    tc_a, tc_b = _tcs(quant)
    step_a, opt_a = make_train_step(cfg, tc_a)
    step_b, opt_b = make_train_step(cfg, tc_b)
    pa, pb = _fresh(params), _fresh(params)
    sa, sb = opt_a.init(pa), opt_b.init(pb)
    assert _shapes(sa) == _shapes(sb)
    for _ in range(5):
        pa, sa, _ = step_a(pa, sa, batch)
        pb, sb, _ = step_b(pb, sb, batch)
    assert _shapes(sa) == _shapes(sb)
    _assert_params_close(pb, pa)


@pytest.mark.parametrize("quant", [False, True])
def test_state_swaps_between_emit_and_apply(quant):
    """3 emit steps then 2 apply steps on the emit path's state give the
    parameters of 5 emit steps: the two paths share one state layout, so a
    checkpoint of either resumes on the other."""
    cfg, params, batch = _smoke()
    tc_a, tc_b = _tcs(quant)
    step_a, opt_a = make_train_step(cfg, tc_a)
    step_b, _ = make_train_step(cfg, tc_b)
    pa, pb = _fresh(params), _fresh(params)
    sa, sb = opt_a.init(pa), opt_a.init(pb)
    for i in range(5):
        pa, sa, _ = step_a(pa, sa, batch)
        pb, sb, _ = (step_a if i < 3 else step_b)(pb, sb, batch)
    assert _shapes(sa) == _shapes(sb)
    _assert_params_close(pb, pa)


def test_passthrough_blocks_equal_one_block(monkeypatch):
    """The apply step's full-shape leaves (core/galore.py passthrough_apply:
    Adam and the weight update a block of rows at a time) with
    _PASSTHROUGH_BLOCK patched to 192 elements — 3 rows of the 64-wide
    leaves, so the 512-row embedding ends in a ragged block — give the
    one-block run's parameters and state bit for bit over 3 steps."""
    from repro_torch.core import galore as core_galore

    cfg, params, batch = _smoke()
    _, tc = _tcs(False)
    runs = []
    for block in (core_galore._PASSTHROUGH_BLOCK, 192):
        monkeypatch.setattr(core_galore, "_PASSTHROUGH_BLOCK", block)
        step, opt = make_train_step(cfg, tc)
        p = _fresh(params)
        s = opt.init(p)
        for _ in range(3):
            p, s, _ = step(p, s, batch)
        runs.append(tree_leaves_with_path({"params": p, "state": {str(i): x
                                                                   for i, x in enumerate(s)}}))
    assert params["embed"]["embedding"].shape[0] % 3 and 192 // 64 == 3
    assert [path for path, _ in runs[0]] == [path for path, _ in runs[1]]
    for (path, a), (_, b) in zip(*runs):
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        assert same, path


@pytest.mark.parametrize("quant", [False, True])
def test_composable_apply_matches_fused_apply(quant):
    """_managed_adam_update folds the weight update into the composable
    branch (its `finish`) exactly as the fused apply wrappers do: on the CPU
    both run the plain versions, so the weights agree bit for bit."""
    _, params, _ = _smoke()
    gcfg = _tcs(quant)[0].galore
    mgr = SubspaceManager(gcfg)
    plans = mgr.plans(params)
    rng = np.random.default_rng(1)
    grads = tree_map(lambda p: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)),
                     params)
    state = galore(gcfg, b1=0.9, b2=0.999, eps=1e-8).init(params)
    proj, _ = mgr.refresh_tree(grads, state["proj"], None, plans, step=0)
    out = {}
    for fused in (True, False):
        inner = tree_map(lambda x: x.clone(), state["inner"])
        p = tree_map(lambda x: x.detach().clone(), params)
        with torch.no_grad():
            out[fused], _ = _managed_adam_update(
                grads, _read_proj_tree(grads, proj, plans, keep_packed=fused), inner, plans,
                gcfg, 0.9, 0.999, 1e-8, fused=fused, params=p, eta=torch.tensor(ETA), wd=WD)
    want = dict(tree_leaves_with_path(out[True]))
    for path, x in tree_leaves_with_path(out[False]):
        assert torch.equal(x, want[path]), path
    assert any(not torch.equal(x, dict(tree_leaves_with_path(params))[path])
               for path, x in tree_leaves_with_path(out[False]))


# ---------------------------------------------------------------------------
# 3. the trajectory against the JAX apply step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
def test_apply_trajectory_matches_jax(quant, tmp_path):
    """20 steps of the W-in-place path (rank 16, T 10, wd 0.01) from the JAX
    package's weights and batches: per-step losses within 5e-2 of JAX's
    galore_fused_apply run, fp32 and 8-bit."""
    steps, batch, seq = 20, 4, 64
    jq = JQuantPolicy(**POLICY) if quant else JQuantPolicy()
    jcfg = jax_get_config("llama_60m", smoke=True)
    jtc = JTrainConfig(optimizer="adamw", galore=JGaLoreConfig(rank=16, update_freq=10, quant=jq),
                       galore_fused_adam=True, galore_fused_apply=True, weight_decay=0.01,
                       total_steps=steps, warmup_steps=2)
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
    tq = QuantPolicy(**POLICY) if quant else QuantPolicy()
    tc = TrainConfig(optimizer="adamw", galore=GaLoreConfig(rank=16, update_freq=10, quant=tq),
                     galore_fused_adam=True, galore_fused_apply=True, weight_decay=0.01,
                     total_steps=steps, warmup_steps=2)
    train_loop(RunConfig(steps=steps, batch_per_host=batch, seq_len=seq, log_every=steps,
                         ckpt_dir=str(tmp_path), device="cpu"),
               tc, cfg=get_config("llama_60m", smoke=True), params=tparams, data=_Bridged(jdata),
               on_step=lambda s, m: got.append(float(m["loss"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
    assert want[-1] < want[0]


# ---------------------------------------------------------------------------
# 4. refusals
# ---------------------------------------------------------------------------


def test_apply_refuses_microbatch_and_a_missing_fused_flag():
    cfg = get_config("llama_60m", smoke=True)
    _, tc = _tcs(False)
    with pytest.raises(ValueError, match="microbatch"):
        make_train_step(cfg, dataclasses.replace(tc, microbatch=2))
    with pytest.raises(ValueError, match="requires galore_fused_adam"):
        make_train_step(cfg, dataclasses.replace(tc, galore_fused_adam=False))


def test_cli_apply_trains_on_cpu_and_needs_galore_fused(tmp_path, capsys):
    cli = ["--steps", "3", "--seq", "32", "--batch", "2", "--galore-rank", "16", "--galore-t",
           "2", "--galore-fused-apply", "--log-every", "1", "--device", "cpu", "--ckpt-dir",
           str(tmp_path)]
    rc, out, err = _main_in_process(cli + ["--galore-fused"], capsys)
    assert rc == 0, err
    losses = [float(line.split()[4]) for line in out.splitlines()
              if line.startswith("[train] step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    rc, _, err = _main_in_process(cli, capsys)
    assert rc == 2
    assert "--galore-fused-apply requires --galore-fused" in err

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
