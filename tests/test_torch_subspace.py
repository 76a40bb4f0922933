"""The port's subspace lifecycle against the JAX package: per-leaf ranks,
stagger (plain and by importance), adaptive T, the state bytes at ragged
ranks, and the external refresh against the in-step one."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.galore import galore as jax_galore  # noqa: E402
from repro.core.galore import galore_state_bytes as jax_galore_state_bytes  # noqa: E402
from repro.core.galore import plan_for_params  # noqa: E402
from repro.core.subspace import SubspaceManager as JSubspaceManager  # noqa: E402
from repro.core.subspace import importance_order_from_grads as jax_importance  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adam import scale_by_adam as jax_scale_by_adam  # noqa: E402
from repro.quant import QuantPolicy as JQuantPolicy  # noqa: E402
from repro_torch.bridge import galore_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.galore import galore, galore_state_bytes, refresh_projectors  # noqa: E402
from repro_torch.core.projector import subspace_overlap  # noqa: E402
from repro_torch.core.subspace import SubspaceManager, importance_order_from_grads  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402
from repro_torch.utils import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

B1, B2, EPS = 0.9, 0.999, 1e-8


def _toy_params():
    rng = np.random.default_rng(0)
    return {"wide": rng.standard_normal((48, 130)).astype(np.float32),
            "tall": rng.standard_normal((130, 48)).astype(np.float32),
            "stack": rng.standard_normal((3, 40, 96)).astype(np.float32),
            "bias": rng.standard_normal((130,)).astype(np.float32)}


def _smoke_params():
    cfg = jax_get_config("llama_60m", smoke=True)
    return jax.tree_util.tree_map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))


def _configs(**kw):
    """(JAX GaLoreConfig, port GaLoreConfig) with the same fields."""
    q = kw.pop("quant", None)
    return (JGaLoreConfig(**kw, **({"quant": JQuantPolicy(**q)} if q else {})),
            GaLoreConfig(**kw, **({"quant": QuantPolicy(**q)} if q else {})))


def _jax_by_path(jtree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(jtree, is_leaf=is_leaf)[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): x
            for path, x in flat}


PLAN_CONFIGS = {
    "default": dict(rank=16, update_freq=5),
    "frac+override": dict(rank=16, rank_frac=0.25, rank_overrides=(("wide", 8),)),
    "override-disables": dict(rank=16, rank_overrides=(("tall", 48),)),
    "frac-ragged": dict(rank=16, rank_frac=0.1),
    "stagger": dict(rank=16, update_freq=12, refresh_stagger=True),
    "stagger-importance": dict(rank=16, update_freq=12, refresh_stagger=True,
                               stagger_by_importance=True,
                               importance_order=("wide", "stack", "tall")),
    "smoke-mlp-override": dict(rank=8, update_freq=8, refresh_stagger=True,
                               rank_overrides=(("ffn.gate", 24), ("ffn.up", 24),
                                               ("ffn.down", 24))),
    "smoke-importance": dict(rank=8, update_freq=7, refresh_stagger=True,
                             stagger_by_importance=True,
                             importance_order=("blocks.ffn.down", "blocks.attn.wo",
                                               "blocks.ffn.up")),
}


@pytest.mark.parametrize("name", list(PLAN_CONFIGS))
def test_plans_match_jax(name):
    """Per leaf: galore, side, rank, period, stagger offset and storage modes
    equal the reference's plans for the same config and param shapes."""
    params = _smoke_params() if name.startswith("smoke") else _toy_params()
    jcfg, cfg = _configs(**PLAN_CONFIGS[name])
    want = _jax_by_path(plan_for_params(params, jcfg), is_leaf=lambda x: hasattr(x, "galore"))
    got = dict(tree_leaves_with_path(SubspaceManager(cfg).plans(params_from_numpy(params, "cpu"))))
    assert sorted(got) == sorted(want)
    fields = ("galore", "side", "rank", "refresh_period", "refresh_offset", "moments",
              "proj_store")
    for path, plan in got.items():
        w = want[path]
        if not w.galore:  # side/rank/period are defaults on a passthrough plan
            assert not plan.galore and plan.moments == w.moments, path
            continue
        assert tuple(getattr(plan, f) for f in fields) == tuple(getattr(w, f) for f in fields), path
    jm, m = JSubspaceManager(jcfg), SubspaceManager(cfg)
    assert m.t_bounds() == jm.t_bounds()


@pytest.mark.parametrize("T,t_min,t_max", [(4, 0, 0), (200, 0, 0), (3, 2, 5), (1, 0, 0)])
def test_t_bounds_and_leaf_rank_match_jax(T, t_min, t_max):
    jcfg, cfg = _configs(rank=16, update_freq=T, t_min=t_min, t_max=t_max, rank_frac=0.3,
                         rank_overrides=(("attn", 7),))
    jm, m = JSubspaceManager(jcfg), SubspaceManager(cfg)
    assert m.t_bounds() == jm.t_bounds()
    for path, mm, nn in (("blocks.attn.wq", 64, 64), ("blocks.ffn.up", 64, 172), ("x", 3, 5)):
        assert m.leaf_rank(path, mm, nn) == jm.leaf_rank(path, mm, nn)


def test_importance_order_matches_jax():
    """The measured order (≥ 2-D leaves by descending gradient norm) equals
    the reference's on the same gradient, for the toy and the smoke model."""
    for params in (_toy_params(), _smoke_params()):
        rng = np.random.default_rng(3)
        grads = jax.tree_util.tree_map(
            lambda p: (rng.uniform(0.1, 10.0) * rng.standard_normal(p.shape)).astype(np.float32),
            params)
        want = jax_importance(grads)
        got = importance_order_from_grads(tree_map(torch.from_numpy, grads))
        assert got == want and len(got) > 2


def _grad_seq(params, i):
    """Step i's gradient: `wide` keeps a fixed 4-dim column space (overlap ≈ 1
    at every refresh), every other leaf is fresh noise (overlap ≈ r/m)."""
    rng = np.random.default_rng(100 + i)
    U = np.linalg.qr(np.random.default_rng(7).standard_normal((48, 8)))[0]
    g = {k: rng.standard_normal(p.shape).astype(np.float32) for k, p in params.items()}
    g["wide"] = (U @ rng.standard_normal((8, 130))).astype(np.float32)
    return g


@pytest.mark.parametrize("policy", ["stagger", "adaptive", "adaptive-stagger"])
def test_refresh_tree_matches_jax(policy):
    """refresh_tree step by step on the same gradients: the same leaves
    refresh, the projectors span the same subspace (overlap > 0.999), and
    under adaptive T the schedule scalars agree: period and next exactly,
    the overlap within 1e-5."""
    params = _toy_params()
    kw = dict(rank=8, update_freq=4, refresh_stagger="stagger" in policy,
              adaptive_t="adaptive" in policy, t_max=16)
    jcfg, cfg = _configs(**kw)
    jm, m = JSubspaceManager(jcfg), SubspaceManager(cfg)
    jplans, plans = jm.plans(params), m.plans(params_from_numpy(params, "cpu"))
    jstate = jax_galore(jax_scale_by_adam(), jcfg).init(params)
    jproj, jsched = jstate["proj"], jstate.get("schedule")
    state = galore(cfg, b1=B1, b2=B2, eps=EPS).init(params_from_numpy(params, "cpu"))
    proj, sched = state["proj"], state.get("schedule")
    key = jax.random.PRNGKey(0)
    refreshed = 0
    for i in range(8):
        g = _grad_seq(params, i)
        jproj2, jsched = jm.refresh_tree(g, jproj, jsched, jplans, key, step=i)
        proj2, sched = m.refresh_tree(tree_map(torch.from_numpy, g), proj, sched, plans, step=i)
        for k in ("wide", "tall", "stack"):
            jchanged = not np.array_equal(np.asarray(jproj2[k]), np.asarray(jproj[k]))
            changed = proj2[k] is not proj[k]
            assert changed == jchanged, (policy, i, k)
            if changed:
                refreshed += 1
                ov = subspace_overlap(proj2[k], torch.from_numpy(np.array(jproj2[k])))
                assert float(ov.min()) > 0.999, (policy, i, k)
        if jsched is not None:
            for k in ("wide", "tall", "stack"):
                assert sched["period"][k] == int(jsched["period"][k]), (i, k)
                assert sched["next"][k] == int(jsched["next"][k]), (i, k)
                assert abs(float(sched["overlap"][k]) - float(jsched["overlap"][k])) <= 1e-5
        jproj, proj = jproj2, proj2
    assert refreshed >= 6
    if "adaptive" in policy:
        assert sched["period"]["wide"] > 4 > sched["period"]["tall"]  # stretched / shrunk


def _step_pair(cfg, params, adaptive_steps=8):
    """The port's in-step refresh and its external refresh on the same
    gradients, step by step: (inline states, external states, updates)."""
    inline = galore(cfg, b1=B1, b2=B2, eps=EPS)
    ext = galore(cfg, b1=B1, b2=B2, eps=EPS, external_refresh=True)
    st_i, st_e = inline.init(params), ext.init(params)
    out = []
    for i in range(adaptive_steps):
        g = tree_map(torch.from_numpy, _grad_seq(tree_map(lambda p: p.detach().numpy(), params), i))
        st_e = refresh_projectors(g, st_e, cfg, step=i)
        u_i, st_i = inline.update(g, st_i, params)
        u_e, st_e = ext.update(g, st_e, params)
        out.append((st_i, st_e, u_i, u_e))
    return out


@pytest.mark.parametrize("adaptive", [False, True], ids=["stagger", "adaptive-stagger"])
def test_external_refresh_equals_inline_bitwise(adaptive):
    """refresh_projectors(step=i) before an update with external_refresh is
    the in-step refresh bit for bit: projectors, schedule, moments and the
    update (the reference's test_partial_external_refresh_matches_inline_stagger,
    bitwise on the CPU)."""
    params = params_from_numpy(_toy_params(), "cpu")
    cfg = GaLoreConfig(rank=8, update_freq=4, refresh_stagger=True, adaptive_t=adaptive)
    for st_i, st_e, u_i, u_e in _step_pair(cfg, params):
        a, b = dict(tree_leaves_with_path(st_i)), dict(tree_leaves_with_path(st_e))
        assert sorted(a) == sorted(b)
        for k in a:
            assert (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                    else a[k] == b[k]), k
        for x, y in zip(tree_leaves(u_i), tree_leaves(u_e)):
            assert torch.equal(x, y)


class _Recorder:
    def __init__(self):
        self.losses = []

    def __call__(self, step, metrics):
        self.losses.append(float(metrics["loss"]))


@pytest.mark.parametrize("adaptive", [False, True], ids=["stagger", "adaptive-stagger"])
def test_external_refresh_loop_equals_inline_loop(tmp_path, adaptive):
    """train_loop with --galore-external-refresh (the refresh caller, its own
    gradient of the step's batch) equals the in-step staggered refresh bit
    for bit: losses and final params. The chain's clip is off: it rescales
    the gradient the in-step refresh sees, while the external refresh, as
    the reference's, decomposes the raw gradient."""
    g = GaLoreConfig(rank=8, update_freq=4, refresh_stagger=True, adaptive_t=adaptive)
    runs = {}
    for ext in (False, True):
        rec = _Recorder()
        tc = TrainConfig(galore=g, galore_fused_adam=True, galore_external_refresh=ext,
                         grad_clip=0.0, total_steps=8, warmup_steps=2, weight_decay=0.01)
        run = launcher.RunConfig(steps=8, batch_per_host=2, seq_len=32, log_every=100,
                                 ckpt_every=0, ckpt_dir=str(tmp_path / str(ext)), device="cpu")
        params, _, _, _ = launcher.train_loop(run, tc, on_step=rec)
        runs[ext] = (rec.losses, params)
    assert runs[True][0] == runs[False][0]
    for a, b in zip(tree_leaves(runs[True][1]), tree_leaves(runs[False][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("quant", [None, dict(moments="int8", projectors="int4")],
                         ids=["fp32", "8bit"])
def test_state_bytes_ragged_ranks_match_jax(quant):
    """galore_state_bytes counts each leaf at its own plan's rank and
    storage mode, as the reference's."""
    params = _toy_params()
    kw = dict(rank=16, rank_frac=0.125, rank_overrides=(("stack", 6),))
    if quant:
        kw["quant"] = dict(quant, min_quant_size=0)
    jcfg, cfg = _configs(**kw)
    want = jax_galore_state_bytes(params, jcfg)
    tparams = params_from_numpy(params, "cpu")
    got = galore_state_bytes(tparams, cfg)
    assert got == pytest.approx(want, rel=0, abs=1e-6)
    assert got["projector_elems"] == 48 * 6 + 48 * 6 + 3 * 40 * 6  # tall, wide 0.125·48; stack 6


@pytest.mark.parametrize("fused", [True, False])
def test_ragged_rank_update_matches_jax(fused):
    """At ragged per-leaf ranks (rank_frac with an override), JAX's state
    after its step-0 refresh, bridged over, gives the port's step-1 update
    within 2e-5 of JAX's (T = 10: no refresh at step 1)."""
    params = _toy_params()
    jcfg, cfg = _configs(rank=16, update_freq=10, scale=0.25, rank_frac=0.25,
                         rank_overrides=(("stack", 6),))
    jopt = jax_galore(jax_scale_by_adam(), jcfg, fused_adam=fused, b1=B1, b2=B2, eps=EPS)
    jstate = jopt.init(params)
    rng = np.random.default_rng(9)
    g0, g1 = ({k: rng.standard_normal(p.shape).astype(np.float32) for k, p in params.items()}
              for _ in range(2))
    _, jstate = jopt.update(g0, jstate, params)
    state = galore_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    assert [tuple(state["proj"][k].shape) for k in ("stack", "tall", "wide")] == \
        [(3, 40, 6), (48, 12), (48, 12)]
    jupd, _ = jopt.update(g1, jstate, params)
    opt = galore(cfg, b1=B1, b2=B2, eps=EPS, fused=fused)
    tparams = params_from_numpy(params, "cpu")
    upd, _ = opt.update(tree_map(torch.from_numpy, g1), state, tparams)
    for k in params:
        np.testing.assert_allclose(upd[k].numpy(), np.asarray(jupd[k]), rtol=0, atol=2e-5,
                                   err_msg=k)


def test_measured_importance_stamps_order(tmp_path):
    """--galore-stagger-importance: train_loop measures the order from the
    first batch's gradient at the initial params and staggers by it."""
    cfg = get_config("llama_60m", smoke=True)
    g = GaLoreConfig(rank=8, update_freq=7, refresh_stagger=True, stagger_by_importance=True)
    tc = TrainConfig(galore=g, total_steps=2, warmup_steps=1)
    from repro_torch.data.pipeline import DataConfig, SyntheticC4
    from repro_torch.models import model as TM

    params = TM.init_params(cfg, seed=0, device="cpu")
    batch = SyntheticC4(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_per_host=2),
                        device="cpu").batch(0)
    stamped = launcher.with_measured_importance(cfg, tc, params, batch).galore
    assert sorted(stamped.importance_order) == sorted(
        path for path, p in tree_leaves_with_path(params) if p.ndim >= 2)
    plans = dict(tree_leaves_with_path(SubspaceManager(stamped).plans(params)))
    first = next(p for p in stamped.importance_order if plans[p].galore)
    assert plans[first].refresh_offset == 0
    assert sorted(pl.refresh_offset for pl in plans.values() if pl.galore) == list(range(7))


@pytest.mark.parametrize("argv,error", [
    (["--galore-rank", "8", "--galore-reproject-moments"], "add --galore-refresh-async"),
    (["--galore-refresh-async"], "requires --galore-rank"),
    (["--galore-external-refresh"], "requires --galore-rank"),
])
def test_cli_refusals(argv, error, capsys):
    with pytest.raises(SystemExit) as e:
        launcher.main(argv + ["--device", "cpu", "--steps", "1"])
    assert e.value.code == 2 and error in capsys.readouterr().err


def test_cli_subspace_flags_and_aliases():
    """The reference's spellings and bare aliases of the subspace flags."""
    ap = launcher.build_parser()
    a = ap.parse_args(["--rank-frac", "0.1", "--adaptive-t", "--stagger"])
    b = ap.parse_args(["--galore-rank-frac", "0.1", "--galore-adaptive-t", "--galore-stagger",
                       "--galore-stagger-importance", "--galore-external-refresh",
                       "--galore-refresh-async", "--galore-reproject-moments"])
    assert (a.galore_rank_frac, a.galore_adaptive_t, a.galore_stagger) == (0.1, True, True)
    assert (b.galore_rank_frac, b.galore_adaptive_t, b.galore_stagger) == (0.1, True, True)
    assert b.galore_stagger_importance and b.galore_external_refresh
    assert b.galore_refresh_async and b.galore_reproject_moments
    defaults = ap.parse_args([])
    assert not (defaults.galore_stagger or defaults.galore_refresh_async
                or defaults.galore_external_refresh) and defaults.galore_rank_frac == 0.0
