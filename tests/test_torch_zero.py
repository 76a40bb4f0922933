"""GaLore-ZeRO in the port (``--galore-zero``, distributed/state_sharding.py)
against the JAX package, in gloo worlds of CPU processes: ZeRO-1 with the
reference's test configuration (int8 moments, int4 P, rank 8, T 4, lr 1e-2)
and with fp32 moments on the fused route — one step's gathered state against
the JAX package's one-device state, 12 steps within rtol 5e-4, per-rank
state bytes against ``galore_zero_state_bytes``; ZeRO-2 against the
reference's compress step; elastic restore of a world of 2's checkpoint
into one process and into a world of 4, and the file read by the JAX
package's manager; the ownership map, the factory's refusals, and the
logical labels and ``tp_aware_side`` plans of all ten architectures."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs.base import ARCH_IDS  # noqa: E402
from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.galore import galore as jax_galore  # noqa: E402
from repro.core.galore import galore_zero_state_bytes as jax_zero_bytes  # noqa: E402
from repro.core.galore import plan_for_params  # noqa: E402
from repro.core.subspace import SubspaceManager as JSubspaceManager  # noqa: E402
from repro.distributed.step import make_refresh_step as jax_make_refresh_step  # noqa: E402
from repro.distributed.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adam import scale_by_adam as jax_scale_by_adam  # noqa: E402
from repro.optim.factory import build_optimizer as jax_build_optimizer  # noqa: E402
from repro.quant import QuantPolicy as JQuantPolicy  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    galore_blocks_from_numpy,
    galore_blocks_to_numpy,
    galore_state_from_numpy,
    params_from_numpy,
)
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.galore import galore, galore_zero_state_bytes  # noqa: E402
from repro_torch.core.subspace import SubspaceManager  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.factory import build_optimizer  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402
from repro_torch.utils import flatten_up_to, tree_leaves_with_path, tree_map  # noqa: E402
from test_torch_cuda import assert_codes_close  # noqa: E402
from test_torch_quant import _assert_close  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401
from torch_world import run_world, train_cases  # noqa: E402

TOKENS = np.random.default_rng(2).integers(0, 512, (8, 32)).astype(np.int32)
Q8 = dict(moments="int8", projectors="int4", min_quant_size=0)
BASE = dict(optimizer="adamw", lr=1e-2, total_steps=20, warmup_steps=2)
FORMS = {  # (TrainConfig kwargs, GaLoreConfig kwargs, the JAX reference's TrainConfig kwargs)
    "zero1_8bit": (dict(galore_zero=1, galore_external_refresh=True), dict(quant=Q8),
                   dict(galore_external_refresh=True)),
    "zero1_fused": (dict(galore_zero=1, galore_fused_adam=True, galore_external_refresh=True),
                    {}, dict(galore_fused_adam=True, galore_external_refresh=True)),
    "zero2": (dict(galore_zero=2, galore_dp_compress=True, galore_external_refresh=True), {},
              dict(galore_dp_compress=True, galore_external_refresh=True)),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jtc(form):
    _, gkw, jkw = FORMS[form]
    gkw = dict(gkw, quant=JQuantPolicy(**gkw["quant"])) if "quant" in gkw else gkw
    return JTrainConfig(galore=JGaLoreConfig(rank=8, update_freq=4, **gkw), **BASE, **jkw)


def _jax_run(form, steps):
    """The JAX package's one-device run, its state replicated (zero 0): the
    unsharded computation ZeRO promises."""
    cfg = jax_get_config("llama_60m", smoke=True)
    tc = _jtc(form)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    step_fn, opt = jax_make_train_step(cfg, tc)
    step_fn = jax.jit(step_fn)
    refresh = jax.jit(jax_make_refresh_step(cfg, tc), static_argnums=(3,))
    state, kept, losses = opt.init(params), [(_np(params), _np(opt.init(params)))], []
    for i in range(steps):
        if i % tc.galore.update_freq == 0:  # due: every leaf (one compile, not one a step)
            state = refresh(params, state, {"tokens": TOKENS}, None)
        params, state, m = step_fn(params, state, {"tokens": TOKENS})
        kept.append((_np(params), _np(state)))
        losses.append(float(m["loss"]))
    return kept, losses


@pytest.fixture(scope="module")
def jax_runs():
    return {f: _jax_run(f, 12) for f in FORMS}


def _spec(form, **kw):
    tkw, gkw, _ = FORMS[form]
    return dict(tc=dict(BASE, **tkw), galore=dict(rank=8, update_freq=4, **gkw), tokens=TOKENS,
                **kw)


@pytest.fixture(scope="module")
def runs(jax_runs, tmp_path_factory):
    """One world of 2: one step of each form from JAX's state after step 0,
    12 steps of each from the initial params, and a train_loop run of the
    8-bit form that checkpoints at step 6; then that checkpoint resumed in
    one process and in a world of 4."""
    tmp = tmp_path_factory.mktemp("zero")
    p0 = jax_runs["zero1_8bit"][0][0][0]
    cases = {}
    for f in FORMS:
        p1, s1 = jax_runs[f][0][1]
        cases[f + "_one"] = _spec(f, params=p1, jstate=s1, steps=1, start=1)
        cases[f + "_12"] = _spec(f, params=p0, steps=12)
    loop = _spec("zero1_8bit", params=p0, steps=12, loop=True, ckpt_every=6,
                 ckpt_dir=str(tmp / "two"))
    cases["loop"] = loop
    out = {"two": run_world(train_cases, 2, tmp, cases)}
    # the port's own unsharded runs (zero 0, no world): what ZeRO promises
    unsharded = {f: dict(cases[f + "_12"], tc=dict(cases[f + "_12"]["tc"], galore_zero=0))
                 for f in FORMS}
    out["unsharded"] = run_world(train_cases, 0, tmp, unsharded)[0]
    for n, name in ((0, "one"), (4, "four")):
        import shutil

        shutil.copytree(tmp / "two", tmp / name)
        out[name] = run_world(train_cases, n, tmp, {"loop": dict(loop, ckpt_dir=str(tmp / name),
                                                                  ckpt_every=0)})
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("form", list(FORMS))
def test_one_step_state_matches_jax(runs, jax_runs, form):
    """The world of 2's gathered state after one step: int codes (moments and
    the int4 P) at most one apart from the JAX package's one-device state
    (ROADMAP C.6; the P codes, carried, bit for bit), f32 state within 2e-5,
    the update within 2e-5 in Frobenius norm (C.24)."""
    got = runs["two"][0][form + "_one"]["first"]
    (p1, _), (p2, s2) = jax_runs[form][0][1], jax_runs[form][0][2]
    want_g = s2[1]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want_g)[0])
    for (path, want), have in zip(flat_w.items(), jax.tree_util.tree_leaves(got["galore"])):
        name = f"{form} {jax.tree_util.keystr(path)}"
        if "proj" in name:
            np.testing.assert_array_equal(np.asarray(have), np.asarray(want), err_msg=name)
        elif np.asarray(want).dtype == np.uint8:
            assert_codes_close(have, want, name)
        elif np.asarray(want).ndim:
            _assert_close(have, want, name, tol=2e-5)
    for (path, w2), h2, b in zip(jax.tree_util.tree_flatten_with_path(p2)[0],
                                 jax.tree_util.tree_leaves(got["params"]),
                                 jax.tree_util.tree_leaves(p1)):
        d, w = np.asarray(h2 - b, np.float64), np.asarray(w2 - b, np.float64)
        assert np.linalg.norm(d - w) <= 2e-5 * np.linalg.norm(w), (form, path)


@pytest.mark.parametrize("form", list(FORMS))
def test_twelve_steps_track_the_unsharded_run(runs, jax_runs, form):
    """12 steps from the same params, on both ranks: every loss within rtol
    5e-4 of the port's unsharded one-process run (the reference's own bar
    between its ZeRO and replicated programs), and within 5e-2 of the JAX
    package's one-device run (ZeRO-2: its compress step with zero 0). The
    port and JAX refresh P by SVDs of their own, which alone moves the
    losses by up to 2.0e-3 relative over these 12 steps (ROADMAP C.25)."""
    want = runs["unsharded"][form]["losses"]
    for rank in runs["two"]:
        got = rank[form + "_12"]["losses"]
        np.testing.assert_allclose(got, want, rtol=5e-4)
        np.testing.assert_allclose(got, jax_runs[form][1], rtol=0, atol=5e-2)


@pytest.mark.parametrize("form", list(FORMS))
def test_per_rank_bytes_are_the_reference_accounting(runs, form):
    """Each rank's optimizer-state bytes, counted from its tensors, against
    the reference's galore_zero_state_bytes at n_dp 2: equal with fp32
    state; with int8 moments and int4 P above it by the codecs' block
    padding and scale remainders only."""
    _, gkw, _ = FORMS[form]
    jcfg = _jtc(form).galore
    cfg = jax_get_config("llama_60m", smoke=True)
    p = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    want = jax_zero_bytes(p, jcfg, 2)["opt_state_bytes_per_replica"]
    port = galore_zero_state_bytes(params_from_numpy(_np(JM.init_params(
        cfg, jax.random.PRNGKey(0))), "cpu"), _port_gcfg(form), 2)
    assert port["opt_state_bytes_per_replica"] == want
    assert port["zero_reduction_vs_replicated"] == pytest.approx(
        jax_zero_bytes(p, jcfg, 2)["zero_reduction_vs_replicated"], rel=1e-12)
    for rank in runs["two"]:
        got = rank[form + "_one"]["first"]["bytes"]["total"]
        if "quant" in gkw:
            assert want <= got <= 1.6 * want, (got, want)
        else:
            assert got == want, (got, want)


def _port_gcfg(form):
    _, gkw, _ = FORMS[form]
    gkw = dict(gkw, quant=QuantPolicy(**gkw["quant"])) if "quant" in gkw else gkw
    return GaLoreConfig(rank=8, update_freq=4, **gkw)


def test_elastic_restore_two_to_one_and_four(runs):
    """The world of 2's ZeRO-1 checkpoint (step 6, the full layout) resumes
    in one process and in a world of 4 (rank blocks of 2): steps 7 … 11
    within 5e-2 of the uninterrupted run's."""
    want = runs["two"][0]["loop"]["losses"]
    for name in ("one", "four"):
        for rank in runs[name]:
            got = rank["loop"]["losses"]
            assert sorted(got) == list(range(7, 12)), (name, sorted(got))
            np.testing.assert_allclose([got[s] for s in range(7, 12)],
                                       [want[s] for s in range(7, 12)], rtol=0, atol=5e-2)
            assert any("resumed from step 6" in ln for ln in rank["loop"]["log"]) == (
                rank is runs[name][0])


@pytest.mark.parametrize("n", [2, 4])
def test_bridge_blocks_round_trip_the_reference_state(jax_runs, n):
    """bridge.galore_blocks_from_numpy cuts the JAX package's 8-bit state
    (int8 moments, int4 P) into n ranks' blocks of a half / quarter of the
    rank dim (the passthrough moments' rows likewise), and
    galore_blocks_to_numpy puts them back: the reference's state bit for
    bit."""
    params, state = jax_runs["zero1_8bit"][0][1]
    tparams = params_from_numpy(params, "cpu")
    gcfg = _port_gcfg("zero1_8bit")
    blocks = [galore_blocks_from_numpy(state[1], tparams, dataclasses.replace(gcfg, zero=1), k,
                                       n, "cpu") for k in range(n)]
    wq = blocks[0]["inner"]["m"]["blocks"]["attn"]["wq"]["q"]
    assert wq.shape == (2, 8 // n, 64)
    back = galore_blocks_to_numpy(blocks, tparams, dataclasses.replace(gcfg, zero=1))
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(state[1])[0],
                                 jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=jax.tree_util.keystr(path))


def test_checkpoint_is_the_reference_format(runs, tmp_path):
    """The JAX package's CheckpointManager reads the world of 2's file, and
    it equals, bit for bit, what a one-process port save of the restored
    (full) state writes."""
    cfg = jax_get_config("llama_60m", smoke=True)
    tc = JTrainConfig(**_spec("zero1_8bit")["tc"],
                      galore=_jtc("zero1_8bit").galore)
    jparams = JM.init_params(cfg, jax.random.PRNGKey(0))
    target = {"opt_state": jax_build_optimizer(tc, param_axes=JM.param_axes(cfg)).init(jparams),
              "params": jparams}
    a = JCheckpointManager(str(runs["tmp"] / "two")).restore(6, target)
    ptc = TrainConfig(**_spec("zero1_8bit")["tc"], galore=_port_gcfg("zero1_8bit"))
    pcfg = get_config("llama_60m", smoke=True)
    params = params_from_numpy(_np(jparams), "cpu")
    opt_state = build_optimizer(ptc, param_axes=M.param_axes(pcfg)).init(params)
    full = CheckpointManager(str(runs["tmp"] / "two")).restore(
        6, {"params": params, "opt_state": opt_state})
    CheckpointManager(str(tmp_path), async_save=False).save(6, full)
    b = JCheckpointManager(str(tmp_path)).restore(6, target)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ---------------------------------------------------------------------------
# the ownership map, the factory, the labels and tp_aware_side
# ---------------------------------------------------------------------------


def test_ownership_axes_equal_the_reference():
    """SubspaceManager.ownership_axes (zero_state_axes of every leaf) equals
    the reference's for the 8-bit and fp32 policies."""
    cfg = jax_get_config("llama_60m", smoke=True)
    jp = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    params = params_from_numpy(_np(JM.init_params(cfg, jax.random.PRNGKey(0))), "cpu")
    for q in ({}, Q8):
        want = JSubspaceManager(JGaLoreConfig(rank=8, zero=1, quant=JQuantPolicy(**q)),
                                param_axes=JM.param_axes(cfg)).ownership_axes(jp)
        got = SubspaceManager(GaLoreConfig(rank=8, zero=1, quant=QuantPolicy(**q)),
                              param_axes=M.param_axes(get_config("llama_60m", smoke=True))
                              ).ownership_axes(params)
        flat_w = jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, dict)
                                           and "moment" in x)
        assert flatten_up_to(params, got) == flat_w


@pytest.mark.parametrize("kw,words", [
    (dict(galore=GaLoreConfig(rank=8, zero=3)), "galore_zero must be 0, 1 or 2"),
    (dict(galore=GaLoreConfig(rank=8, zero=2)), "requires the galore_dp_compress"),
    (dict(galore=GaLoreConfig(rank=8, zero=2, quant=QuantPolicy(moments="int8")),
          galore_dp_compress=True), "galore_zero=2 requires fp32 moments"),
])
def test_factory_refuses_what_the_reference_refuses(kw, words):
    with pytest.raises(ValueError, match=words):
        build_optimizer(TrainConfig(optimizer="adamw", **kw))
    build_optimizer(TrainConfig(optimizer="adamw", galore=GaLoreConfig(rank=8, zero=1)))
    build_optimizer(TrainConfig(optimizer="adamw", galore_dp_compress=True,
                                galore=GaLoreConfig(rank=8, zero=2)))


@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_param_axes_and_tp_aware_plans_equal_the_reference(arch):
    """models/model.py::param_axes equals the reference's M.param_axes at
    smoke; under tp_aware_side every leaf's plan (galore, side, rank) is the
    reference's."""
    jcfg = jax_get_config(arch, smoke=True)
    axes = M.param_axes(get_config(arch, smoke=True))
    assert axes == JM.param_axes(jcfg)
    jp = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
    want = plan_for_params(jp, JGaLoreConfig(rank=8, tp_aware_side=True),
                           param_axes=JM.param_axes(jcfg))
    want = [(w.galore, w.side if w.galore else None, w.rank) for w in jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: hasattr(x, "galore"))]
    params = jax.tree_util.tree_map(lambda x: torch.empty(x.shape, device="meta"), jp)
    got = [(g.galore, g.side if g.galore else None, g.rank) for _, g in tree_leaves_with_path(
        SubspaceManager(GaLoreConfig(rank=8, tp_aware_side=True), param_axes=axes).plans(params))]
    assert got == want


def test_tp_aware_side_update_matches_jax():
    """One GaLore update under tp_aware_side at the projectors JAX's first
    step refreshed (the square (heads_flat, embed) wo keeps its replicated
    embed dim: the shape rule's left side becomes right), within 2e-5·max."""
    hp = dict(b1=0.9, b2=0.999, eps=1e-8)
    cfg = jax_get_config("llama_60m", smoke=True)
    params = _np(JM.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    grads = [jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                    params) for _ in range(2)]
    jopt = jax_galore(jax_scale_by_adam(), JGaLoreConfig(rank=8, update_freq=10,
                                                          tp_aware_side=True),
                      param_axes=JM.param_axes(cfg), **hp)
    jupdate = jax.jit(jopt.update)
    _, jstate = jupdate(grads[0], jopt.init(params), params)
    state = galore_state_from_numpy(_np(jstate), "cpu")
    jupd, _ = jupdate(grads[1], jstate, params)
    opt = galore(GaLoreConfig(rank=8, update_freq=10, tp_aware_side=True),
                 param_axes=M.param_axes(get_config("llama_60m", smoke=True)), **hp)
    upd, _ = opt.update(tree_map(torch.from_numpy, grads[1]), state,
                        params_from_numpy(params, "cpu"))
    plans = dict(tree_leaves_with_path(SubspaceManager(
        GaLoreConfig(rank=8, tp_aware_side=True),
        param_axes=M.param_axes(get_config("llama_60m", smoke=True))).plans(
            params_from_numpy(params, "cpu"))))
    assert plans["blocks.attn.wo"].side == "right"
    for (path, want), (_, have) in zip(jax.tree_util.tree_flatten_with_path(jupd)[0],
                                       tree_leaves_with_path(upd)):
        _assert_close(have.numpy(), np.asarray(want), jax.tree_util.keystr(path), tol=2e-5)
