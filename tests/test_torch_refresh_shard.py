"""The sharded refresh of the port (``--galore-refresh-shard``) against the JAX
package: ``partition_refresh``'s assignments and loads equal the
reference's exactly, the bin-packing bound holds, the SVD cost table is
measured, and in gloo worlds of 2 and 3 CPU processes the sharded refresh's
projectors are bit for bit the unsharded refresh's on the same reduced
gradient (svd, randomized and Newton–Schulz projectors, stagger, adaptive
T, guard_refresh); a 20-step run of the sharded refresh tracks the JAX
package's external-refresh run, and the async sharded refresh the port's
one-process async run, recalibrating its SVD costs every N dispatches."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ARCH_IDS  # noqa: E402
from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.subspace import SubspaceManager as JSubspaceManager  # noqa: E402
from repro.distributed.step import make_refresh_step as jax_make_refresh_step  # noqa: E402
from repro.distributed.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, get_config  # noqa: E402
from repro_torch.core.subspace import (  # noqa: E402
    SubspaceManager,
    calibrate_unit_costs,
    leaf_unit_cost,
)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.utils import tree_leaves, tree_leaves_with_path  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401
from torch_world import loop_run, refresh_parity, run_world, train_losses  # noqa: E402

ARCHS = list(ARCH_IDS) + ["llama_60m"]


def _struct(arch):
    """The smoke params' shapes as meta tensors in the port's tree (nothing
    drawn)."""
    return jax.tree_util.tree_map(lambda x: torch.empty(x.shape, device="meta"),
                                  _jstruct(arch)[0])


def _jstruct(arch):
    cfg = jax_get_config(arch, smoke=True)
    return jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0))), JM.param_axes(cfg)


# ---------------------------------------------------------------------------
# partition_refresh: the reference's assignment, exactly
# ---------------------------------------------------------------------------


def _partition_cases(arch):
    """(GaLoreConfig kwargs) cases: plain, staggered (partial dueness), with a
    measured cost table, and importance-ordered."""
    jp, _ = _jstruct(arch)
    paths = [".".join(str(k.key) if hasattr(k, "key") else str(k.idx) for k in pth)
             for pth, x in jax.tree_util.tree_flatten_with_path(jp)[0] if x.ndim >= 2]
    costs = tuple(sorted({((64, 128, 8), 0.5), ((64, 64, 8), 2.0), ((128, 64, 8), 0.25)}))
    return [dict(rank=8, update_freq=4),
            dict(rank=8, update_freq=4, refresh_stagger=True),
            dict(rank=8, update_freq=4, unit_costs=costs),
            dict(rank=8, update_freq=4, refresh_stagger=True, stagger_by_importance=True,
                 importance_order=tuple(reversed(paths)), unit_costs=costs)]


@pytest.mark.parametrize("arch", ARCHS)
def test_partition_refresh_equals_reference(arch):
    """Assignments and loads equal the reference's for every smoke config at
    n_shards 1 … 8, stacked leaves included, with and without unit_costs and
    importance_order, force-all and at a partial stagger step."""
    jp, jaxes = _jstruct(arch)
    params = _struct(arch)
    axes = M.param_axes(get_config(arch, smoke=True))
    for kw in _partition_cases(arch):
        jm = JSubspaceManager(JGaLoreConfig(**kw), param_axes=jaxes)
        m = SubspaceManager(GaLoreConfig(**kw), param_axes=axes)
        for step in (None, 1):
            for n in range(1, 9):
                ja, jl = jm.partition_refresh(jp, step, n)
                a, loads = m.partition_refresh(params, step, n)
                np.testing.assert_array_equal(loads, jl, err_msg=f"{arch} {kw} {step} {n}")
                want = [np.asarray(x) for x in jax.tree_util.tree_leaves(ja)]
                got = tree_leaves(a)
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w, err_msg=f"{arch} {kw} {step} {n}")


def _check_partition(n_leaves, n_shards, lead, seed):
    """Every unit assigned once, the loads its costs, max bin ≤ mean + max c_i
    (tests/test_properties.py's invariants), on random shapes."""
    rng = np.random.RandomState(seed)
    params = {}
    for i in range(n_leaves):
        m, n = int(rng.randint(12, 80)), int(rng.randint(12, 80))
        params[f"w{i}"] = torch.zeros((lead, m, n) if rng.rand() < 0.5 else (m, n),
                                      device="meta")
    params["bias"] = torch.zeros((7,), device="meta")
    cfg = GaLoreConfig(rank=8, update_freq=4)
    mgr = SubspaceManager(cfg)
    plans = dict(tree_leaves_with_path(mgr.plans(params)))
    assignment, loads = mgr.partition_refresh(params, None, n_shards)
    per, total, costs = np.zeros(n_shards), 0.0, []
    for k, p in params.items():
        a = np.asarray(assignment[k]).reshape(-1)
        if not plans[k].galore:
            assert (a == -1).all()
            continue
        assert a.shape == (p.shape[0] if p.ndim > 2 else 1,)
        assert ((a >= 0) & (a < n_shards)).all()
        m, n = p.shape[-2:] if plans[k].side == "left" else p.shape[-1:-3:-1]
        c = leaf_unit_cost(m, n, 8)
        costs.append(c)
        for s in a:
            per[s] += c
            total += c
    np.testing.assert_allclose(per, loads, rtol=1e-12)
    if costs:
        assert loads.max() <= total / n_shards + max(costs) + 1e-6


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # the same invariants on seeded draws
    @pytest.mark.parametrize("case", range(24))
    def test_partition_bound_property(case):
        rng = np.random.RandomState(case)
        _check_partition(int(rng.randint(1, 11)), int(rng.randint(1, 10)),
                         int(rng.randint(1, 5)), case)
else:
    @settings(max_examples=40, deadline=None)
    @given(n_leaves=st.integers(1, 10), n_shards=st.integers(1, 9), lead=st.integers(1, 4),
           seed=st.integers(0, 2 ** 16))
    def test_partition_bound_property(n_leaves, n_shards, lead, seed):
        _check_partition(n_leaves, n_shards, lead, seed)


def test_calibrated_costs_cover_every_shape_and_steer_the_packing():
    """calibrate_unit_costs times one projector compute per distinct
    (m, n, rank) shape after the side swap; a table that makes one shape
    dear moves that shape's units apart, exactly as the reference packs on
    the same table."""
    cfg = get_config("llama_60m", smoke=True)
    params = M.init_params(cfg, device="cpu")
    gcfg = GaLoreConfig(rank=8, update_freq=4)
    costs = calibrate_unit_costs(params, gcfg, iters=1)
    shapes = {k for k, _ in costs}
    assert shapes == {(64, 64, 8), (64, 128, 8)} and all(v > 0 for _, v in costs)
    dear = tuple((k, 100.0 if k == (64, 128, 8) else 1.0) for k, _ in costs)
    jp, jaxes = _jstruct("llama_60m")
    ja, jl = JSubspaceManager(JGaLoreConfig(rank=8, update_freq=4, unit_costs=dear),
                              param_axes=jaxes).partition_refresh(jp, None, 3)
    a, loads = SubspaceManager(GaLoreConfig(rank=8, update_freq=4, unit_costs=dear),
                               param_axes=M.param_axes(cfg)).partition_refresh(params, None, 3)
    np.testing.assert_array_equal(loads, jl)
    for g, w in zip(tree_leaves(a), jax.tree_util.tree_leaves(ja)):
        np.testing.assert_array_equal(g, np.asarray(w))


# ---------------------------------------------------------------------------
# worlds of 2 and 3: P bit for bit the unsharded refresh's
# ---------------------------------------------------------------------------


def _np_params():
    cfg = jax_get_config("llama_60m", smoke=True)
    return jax.tree_util.tree_map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))


TOKENS = np.random.default_rng(0).integers(0, 512, (12, 32)).astype(np.int32)

PARITY = {
    "svd": dict(rank=8, update_freq=4),
    "randomized": dict(rank=8, update_freq=4, projector="randomized"),
    "newton_schulz": dict(rank=8, update_freq=4, projector="newton_schulz"),
    "stagger": dict(rank=8, update_freq=4, refresh_stagger=True),
    "adaptive": dict(rank=8, update_freq=2, adaptive_t=True, refresh_stagger=True),
    "guard": dict(rank=8, update_freq=4, guard_refresh=True),
    "int4_lazy": dict(rank=8, update_freq=4, quant={"projectors": "int4", "lazy_refresh": True}),
}
STEPS = [None, 1, 2, 4]


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Every PARITY config's refresh sequence in a world of 2, and the svd,
    stagger and guard ones in a world of 3 (global batch 12): one spawned
    world each."""
    spec = dict(params=_np_params(), tokens=TOKENS, tc=dict(galore_refresh_shard=True),
                refresh_steps=STEPS, poison_at={"guard": STEPS.index(4)})
    out = {}
    for n, names in ((2, list(PARITY)), (3, ["svd", "stagger", "guard"])):
        ranks = run_world(refresh_parity, n, tmp_path_factory.mktemp("w"),
                          dict(spec, cases={k: PARITY[k] for k in names}))
        out.update({(n, k): [r[k] for r in ranks] for k in names})
    return out


@pytest.mark.parametrize("n,name", [(2, k) for k in PARITY]
                         + [(3, k) for k in ("svd", "stagger", "guard")])
def test_sharded_refresh_bitwise_unsharded(parity, n, name):
    """At every refresh call, on every rank: projectors (their int4 codes and
    scales) and schedule scalars bit for bit the unsharded refresh's; the
    force-all refresh's units split over the ranks, and none computed on a
    poisoned snapshot."""
    per_rank = parity[n, name]
    for k, calls in enumerate(zip(*per_rank)):
        assert all(c["equal"] for c in calls), (n, name, k)
        for key in ("units", "loads", "valid"):
            assert all(c[key] == c[key + "_counted"] for c in calls), (n, name, k, key)
        total = sum(c["units"] for c in calls)
        if STEPS[k] is None:  # every stacked element of the 7 galore leaves
            assert total == 7 * 2, (n, name, total)
            assert all(c["units"] > 0 for c in calls)
        if name == "guard" and STEPS[k] == 4:
            assert total == 0 and not any(c["valid"] for c in calls)


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------


def _jax_losses(tc, tokens, steps, external):
    cfg = jax_get_config("llama_60m", smoke=True)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    step_fn, opt = jax_make_train_step(cfg, tc)
    step_fn = jax.jit(step_fn)
    refresh = jax.jit(jax_make_refresh_step(cfg, tc), static_argnums=(3,)) if external else None
    state, out = opt.init(params), []
    batch = {"tokens": tokens}
    for i in range(steps):
        if refresh is not None and i % tc.galore.update_freq == 0:  # due: every leaf
            state = refresh(params, state, batch, None)
        params, state, m = step_fn(params, state, batch)
        out.append(float(m["loss"]))
    return out


def test_sharded_refresh_trajectory_matches_jax(tmp_path):
    """20 steps, world of 2, the sharded refresh (rank 8, T 4, lr 1e-2,
    global batch 8 × 32): every loss within 5e-2 of the JAX package's
    one-device external-refresh run."""
    tokens = TOKENS[:8]
    want = _jax_losses(JTrainConfig(optimizer="adamw", lr=1e-2, total_steps=20, warmup_steps=2,
                                    galore=JGaLoreConfig(rank=8, update_freq=4),
                                    galore_external_refresh=True), tokens, 20, True)
    spec = dict(params=_np_params(), tokens=tokens, steps=20,
                tc=dict(optimizer="adamw", lr=1e-2, total_steps=20, warmup_steps=2,
                        galore_refresh_shard=True),
                galore=dict(rank=8, update_freq=4))
    got = run_world(train_losses, 2, tmp_path, spec)
    for rank_losses in got:
        np.testing.assert_allclose(rank_losses, want, rtol=0, atol=5e-2)
    assert want[-1] < want[0]


def test_async_sharded_refresh_and_recalibration(tmp_path):
    """The async sharded refresh with stagger, world of 2, against the
    port's one-process async run: 20 steps within 5e-2. With
    --galore-recalibrate-costs 3 the driver re-measures the SVD costs and
    rebuilds its refresh every third dispatch, on both ranks."""
    base = dict(params=_np_params(), tokens=TOKENS[:8], steps=20,
                galore=dict(rank=8, update_freq=4, refresh_stagger=True))
    tc = dict(optimizer="adamw", lr=1e-2, total_steps=20, warmup_steps=2,
              galore_refresh_async=True)
    one = run_world(loop_run, 0, tmp_path, dict(base, tc=tc, ckpt_dir=str(tmp_path / "one")))[0]
    two = run_world(loop_run, 2, tmp_path,
                    dict(base, ckpt_dir=str(tmp_path / "two"),
                         tc=dict(tc, galore_refresh_shard=True, galore_recalibrate_every=3)))
    want = [one["losses"][s] for s in range(20)]
    for r in two:
        np.testing.assert_allclose([r["losses"][s] for s in range(20)], want, rtol=0, atol=5e-2)
    # 7 galore leaves staggered over T = 4: dispatches at every step after 0
    assert two[0]["recalibrations"] == two[1]["recalibrations"] == 19 // 3
    assert sum("[train] recalibrated" in ln for ln in two[0]["log"]) == 19 // 3
    assert not any("[train]" in ln for ln in two[1]["log"])  # rank 0 alone prints
