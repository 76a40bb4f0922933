"""Data-parallel training of the port (distributed/world.py, the DP and
GaLore-DP train steps) against the JAX package, in gloo worlds of CPU
processes: a world of 2 on one global batch against the JAX package's
one-device ``make_train_step`` (one update from the same state for the fp32
emit, fused and W-in-place forms, 8-bit GaLore with an int4 P and an MoE
model, and a 20-step trajectory); a world of 1 bit for bit no world; GaLore-DP with no
world and in a world of 2 against the reference's own compress step, and its
refusals; the launcher under ``torch.distributed.run`` and its flags'
refusals."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.galore import galore as jax_galore  # noqa: E402
from repro.distributed.step import make_refresh_step as jax_make_refresh_step  # noqa: E402
from repro.distributed.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adam import scale_by_adam as jax_scale_by_adam  # noqa: E402
from repro.quant import QuantPolicy as JQuantPolicy  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.galore import galore  # noqa: E402
from repro_torch.distributed import world  # noqa: E402
from repro_torch.distributed.step import make_train_step  # noqa: E402
from repro_torch.launch import train as T  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402
from test_torch_cuda import assert_codes_close  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401
from torch_world import collectives_check, run_world, train_cases  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = np.random.default_rng(1).integers(0, 512, (8, 32)).astype(np.int32)
POLICY = dict(moments="int8", projectors="int4")
BASE = dict(optimizer="adamw", lr=1e-2, total_steps=20, warmup_steps=2)
FORMS = {  # TrainConfig / GaLoreConfig keyword arguments of each checked form
    "emit": ({}, {}),
    "fused": (dict(galore_fused_adam=True), {}),
    "apply": (dict(galore_fused_adam=True, galore_fused_apply=True), {}),
    "8bit": (dict(galore_fused_adam=True), dict(quant=POLICY)),
    "compress": (dict(galore_dp_compress=True, galore_external_refresh=True), {}),
    "moe": ({}, {}),
}
ARCH = {"moe": "grok_1_314b"}  # the forms not at llama_60m: the Switch aux loss


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_run(form, steps):
    """The JAX package's one-device run of `form` from PRNGKey(0)'s params:
    (params and chain state in numpy after every step, losses)."""
    tkw, gkw = FORMS[form]
    gkw = dict(gkw, quant=JQuantPolicy(**gkw["quant"])) if "quant" in gkw else gkw
    tc = JTrainConfig(galore=JGaLoreConfig(rank=8, update_freq=4, **gkw), **BASE, **tkw)
    cfg = jax_get_config(ARCH.get(form, "llama_60m"), smoke=True)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    step_fn, opt = jax_make_train_step(cfg, tc)
    step_fn = jax.jit(step_fn)
    refresh = (jax.jit(jax_make_refresh_step(cfg, tc), static_argnums=(3,))
               if tc.galore_external_refresh else None)
    state, kept, losses = opt.init(params), [(_np(params), None)], []
    batch = {"tokens": TOKENS}
    for i in range(steps):
        if refresh is not None and i % tc.galore.update_freq == 0:  # due: every leaf
            state = refresh(params, state, batch, None)
        params, state, m = step_fn(params, state, batch)
        kept.append((_np(params), _np(state)))
        losses.append(float(m["loss"]))
    return kept, losses


@pytest.fixture(scope="module")
def jax_runs():
    return {f: _jax_run(f, 20 if f in ("fused", "compress") else 2) for f in FORMS}


def _spec(form, **kw):
    tkw, gkw = FORMS[form]
    return dict(tc=dict(BASE, **tkw), galore=dict(rank=8, update_freq=4, **gkw),
                tokens=TOKENS, arch=ARCH.get(form, "llama_60m"), **kw)


def _from_step1(jax_runs, form):
    """The spec of one step from the JAX run's params and state after step 0."""
    (p1, s1) = jax_runs[form][0][1]
    return _spec(form, params=p1, jstate=s1, steps=1, start=1)


@pytest.fixture(scope="module")
def world2(jax_runs, tmp_path_factory):
    """One spawned world of 2: one step of every form from the JAX state,
    and the 20-step fused and compress trajectories."""
    p0 = jax_runs["fused"][0][0][0]
    cases = {f: _from_step1(jax_runs, f) for f in FORMS}
    cases.update(traj=_spec("fused", params=p0, steps=20),
                 compress_traj=_spec("compress", params=p0, steps=20))
    return run_world(train_cases, 2, tmp_path_factory.mktemp("w2"), cases)


def _assert_frobenius(got, want, name, tol=2e-5):
    """‖got − want‖_F ≤ tol·‖want‖_F (ROADMAP C.24: elementwise, Adam turns
    the f32 summation noise of a near-zero gradient element into an O(lr)
    update, in the port's one-process step against JAX's too)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want), name


def _check_step(got, jax_runs, form):
    """The update of the step after step 0 within 2e-5 of JAX's in each
    leaf's Frobenius norm, the f32 moments likewise, int codes at most one
    apart."""
    (p1, _), (p2, s2) = jax_runs[form][0][1], jax_runs[form][0][2]
    for (path, want2), have2, before in zip(jax.tree_util.tree_flatten_with_path(p2)[0],
                                            jax.tree_util.tree_leaves(got["first"]["params"]),
                                            jax.tree_util.tree_leaves(p1)):
        _assert_frobenius(have2 - before, want2 - before, f"{form} {jax.tree_util.keystr(path)}")
    for name in ("m", "v"):
        for want, have in zip(jax.tree_util.tree_leaves(s2[1]["inner"][name]),
                              jax.tree_util.tree_leaves(got["first"]["galore"]["inner"][name])):
            if want.dtype == np.uint8:
                assert_codes_close(have, want, f"{form} {name}")
            else:
                _assert_frobenius(have, want, f"{form} {name}")


@pytest.mark.parametrize("form", list(FORMS))
def test_world_of_two_step_matches_jax(world2, jax_runs, form):
    """A world of 2 splits the global batch of 8; its step (emit, fused,
    W-in-place, 8-bit with int4 P, GaLore-DP, and an MoE model, whose Switch
    aux loss reads the token fraction of the whole batch) equals the JAX
    package's one-device step on the whole batch."""
    for rank in world2:
        assert len(rank[form]["losses"]) == 1
    _check_step(world2[0][form], jax_runs, form)
    want = jax_runs[form][1][1]
    for rank in world2:
        assert abs(rank[form]["losses"][0] - want) < 1e-5


@pytest.mark.parametrize("case,form", [("traj", "fused"), ("compress_traj", "compress")])
def test_world_of_two_trajectory_matches_jax(world2, jax_runs, case, form):
    """20 steps in a world of 2, every loss within 5e-2 of JAX's one-device
    run (GaLore-DP: of the reference's compress step)."""
    want = jax_runs[form][1]
    for rank in world2:
        np.testing.assert_allclose(rank[case]["losses"], want, rtol=0, atol=5e-2)
    assert want[-1] < want[0]


def test_galore_dp_without_a_world_matches_jax(jax_runs, tmp_path):
    """No world: the compress step takes the reference's two virtual shards,
    so one process computes the reference's CPU step: one step within
    2e-5·max, 20 steps within 5e-2."""
    res = run_world(train_cases, 0, tmp_path, {
        "one": _from_step1(jax_runs, "compress"),
        "traj": _spec("compress", params=jax_runs["compress"][0][0][0], steps=20)})[0]
    _check_step(res["one"], jax_runs, "compress")
    np.testing.assert_allclose(res["traj"]["losses"], jax_runs["compress"][1], rtol=0, atol=5e-2)


def test_world_of_one_is_no_world_bit_for_bit(jax_runs, tmp_path):
    """A world of 1 calls every collective and returns what no world
    computes, bit for bit: losses, params and the galore state after 3
    steps of fused fp32, 8-bit with int4 P and ZeRO-1."""
    p0 = jax_runs["fused"][0][0][0]
    cases = {"fused": _spec("fused", params=p0, steps=3, keep_all=True),
             "8bit": _spec("8bit", params=p0, steps=3, keep_all=True),
             "zero1": dict(_spec("fused", params=p0, steps=3, keep_all=True),
                           tc=dict(BASE, galore_fused_adam=True, galore_zero=1))}
    one = run_world(train_cases, 1, tmp_path, cases)[0]
    none = run_world(train_cases, 0, tmp_path, cases)[0]
    for name in cases:
        assert one[name]["losses"] == none[name]["losses"], name
        for a, b in zip(jax.tree_util.tree_leaves(one[name]["kept"][-1]["params"]),
                        jax.tree_util.tree_leaves(none[name]["kept"][-1]["params"])):
            np.testing.assert_array_equal(a, b, err_msg=name)
        for a, b in zip(jax.tree_util.tree_leaves(one[name]["kept"][-1]["galore"]),
                        jax.tree_util.tree_leaves(none[name]["kept"][-1]["galore"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_galore_dp_refusals_are_the_reference():
    """pre_projected gradients refuse the fused kernels and quantized
    moments, and the guard refuses GaLore-DP, with the reference's words."""
    hp = dict(b1=0.9, b2=0.999, eps=1e-8)
    assert _message(lambda: galore(GaLoreConfig(rank=8), fused=True, pre_projected=True,
                                   **hp)) == _message(
        lambda: jax_galore(jax_scale_by_adam(), JGaLoreConfig(rank=8), fused_adam=True,
                           pre_projected=True, **hp))
    q = QuantPolicy(moments="int8")
    assert _message(lambda: galore(GaLoreConfig(rank=8, quant=q), pre_projected=True,
                                   **hp)) == _message(
        lambda: jax_galore(jax_scale_by_adam(), JGaLoreConfig(rank=8, quant=JQuantPolicy(
            moments="int8")), pre_projected=True, **hp))
    kw = dict(anomaly_guard=True, galore_dp_compress=True)
    assert _message(lambda: make_train_step(get_config("llama_60m", smoke=True), TrainConfig(
        galore=GaLoreConfig(rank=8), **kw))) == _message(lambda: jax_make_train_step(
            jax_get_config("llama_60m", smoke=True), JTrainConfig(galore=JGaLoreConfig(rank=8),
                                                                  **kw)))
    assert not world.in_world() and world.rank() == 0 and world.n_dp() == 1


def test_collectives_in_a_gloo_world_of_two(tmp_path):
    """distributed/world.py's sum, mean (f32, cast back to bf16), all-gather,
    reduce-scatter and broadcast on CPU tensors equal the host computation;
    nothing is staged."""
    for k, r in enumerate(run_world(collectives_check, 2, tmp_path, "cpu")):
        assert r["devices"] == {"cpu"} and r["staged"] == 0
        for name, (got, want) in r["results"].items():
            assert torch.equal(got, want), (k, name)


def test_shard_batch_splits_rows_and_refuses_ragged():
    """Rank k's rows [k·B/n, (k+1)·B/n) of every batch leaf (M-RoPE positions
    on dim 1); B not divisible by n raises."""
    b = {"tokens": torch.arange(24).reshape(8, 3), "positions": torch.zeros(3, 8, 3)}
    got = world.shard_batch(b, k=1, n=4)
    assert torch.equal(got["tokens"], b["tokens"][2:4])
    assert got["positions"].shape == (3, 2, 3)
    with pytest.raises(ValueError, match="divisible by n_dp"):
        world.shard_batch(b, k=0, n=3)
    assert world.shard_batch(b) is b  # no world: the whole batch


# ---------------------------------------------------------------------------
# the launcher under torch.distributed.run
# ---------------------------------------------------------------------------


def _losses(text):
    return [float(ln.split()[4]) for ln in text.splitlines() if ln.startswith("[train] step")]


def _main(argv, capsys):
    try:
        T.main(argv)
        rc = 0
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


ARGS = ["--device", "cpu", "--galore-rank", "8", "--galore-t", "4", "--steps", "4", "--seq",
        "32", "--batch", "8", "--log-every", "1", "--lr", "1e-2", "--ckpt-every", "2"]


def test_cli_world_of_two_zero1_matches_one_process(tmp_path, capsys):
    """`torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.train
    --dist-backend gloo --galore-zero 1 …`: rank 0 alone prints its [train]
    lines, each loss within 5e-2 of a one-process run, and the checkpoint
    it writes (the full layout) resumes in one process."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    ck2 = str(tmp_path / "two")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.launch.train", "--dist-backend", "gloo", "--galore-zero",
           "1", "--galore-refresh-shard", *ARGS, "--ckpt-dir", ck2]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = _losses(proc.stdout)
    assert len(got) == 4  # one rank printed
    rc, out, _ = _main(ARGS + ["--galore-zero", "1", "--galore-refresh-shard", "--ckpt-dir",
                               str(tmp_path / "one")], capsys)
    assert rc == 0
    np.testing.assert_allclose(got, _losses(out), rtol=0, atol=5e-2)
    rc, out, _ = _main(ARGS + ["--galore-zero", "1", "--galore-refresh-shard", "--ckpt-dir",
                               ck2], capsys)
    assert rc == 0 and "[train] resumed from step 2" in out
    np.testing.assert_allclose(_losses(out), got[3:], rtol=0, atol=5e-2)


@pytest.mark.parametrize("argv,words", [
    (["--galore-zero", "1"], "--galore-zero requires --galore-rank"),
    (["--galore-dp-compress"], "--galore-dp-compress requires --galore-rank"),
    (["--galore-refresh-shard"], "--galore-refresh-shard requires --galore-rank"),
    (["--galore-tp-aware-side"], "--galore-tp-aware-side requires --galore-rank"),
    (["--galore-rank", "8", "--galore-recalibrate-costs", "2"],
     "--galore-recalibrate-costs is driven by the async refresh driver"),
    (["--galore-rank", "8", "--galore-zero", "2", "--quant-moments", "int8"],
     "--galore-zero 2 reduce-scatters compact gradients"),
])
def test_cli_refuses_bad_flag_combinations(argv, words, capsys):
    rc, _, err = _main(["--device", "cpu"] + argv, capsys)
    assert rc == 2 and words in err
