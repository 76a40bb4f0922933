"""The port's async double-buffered refresh (P_active / P_next) against the
JAX package: the pending buffer's layout and flags, dispatch + swap against
the synchronous refresh, the moment re-projection (fp32 and int8) against
JAX's swap, the launcher's driver against a synchronous emulation of it, and
a 20-step async + stagger trajectory against the reference's own driver on
one device (its launcher's host mesh refuses its sharding constraints on the
CPU: ROADMAP C.4)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import galore as jgal  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticC4 as JSyntheticC4  # noqa: E402
from repro.distributed.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.launch.train import AsyncRefreshDriver as JAsyncRefreshDriver  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adam import scale_by_adam as jax_scale_by_adam  # noqa: E402
from repro.quant import QuantPolicy as JQuantPolicy  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    galore_state_from_numpy,
    params_from_numpy,
    pending_from_numpy,
)
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.galore import (  # noqa: E402
    galore,
    init_pending_state,
    refresh_projectors,
    refresh_projectors_pending,
    swap_pending_state,
)
from repro_torch.data.pipeline import DataConfig, SyntheticC4  # noqa: E402
from repro_torch.distributed.step import (  # noqa: E402
    make_async_refresh_step,
    make_refresh_step,
    make_swap_step,
    make_train_step,
)
from repro_torch.launch.train import RunConfig, galore_due_offsets, train_loop  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim.factory import galore_state_index  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402
from repro_torch.utils import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

B1, B2, EPS = 0.9, 0.999, 1e-8


def _toy(seed=0):
    """One left leaf and one right leaf, and a gradient for each."""
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((24, 64)).astype(np.float32),
              "b": rng.standard_normal((48, 32)).astype(np.float32)}
    grads = {k: rng.standard_normal(p.shape).astype(np.float32) for k, p in params.items()}
    return params, grads


def _cfgs(**kw):
    q = kw.pop("quant", None)
    base = dict(rank=8, update_freq=4, **kw)
    return (JGaLoreConfig(**base, **({"quant": JQuantPolicy(**q)} if q else {})),
            GaLoreConfig(**base, **({"quant": QuantPolicy(**q)} if q else {})))


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return dict(tree_leaves_with_path(tree))


def _assert_bitwise(a, b):
    a, b = _flat(a), _flat(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor) else a[k] == b[k]), k


@pytest.mark.parametrize("kw", [{}, {"adaptive_t": True},
                                {"quant": dict(moments="int8", projectors="int4",
                                               min_quant_size=0)}],
                         ids=["fp32", "adaptive", "int4p"])
def test_pending_layout_matches_jax(kw):
    """init_pending_state has the reference's paths, shapes and dtypes, and
    a refresh's pending buffer has its structure (the restore target of a
    checkpoint taken with a refresh in flight)."""
    params, grads = _toy()
    jcfg, cfg = _cfgs(**kw)
    want = {k: np.asarray(v) for k, v in _flat_jax(jgal.init_pending_state(params, jcfg)).items()}
    tparams = params_from_numpy(params, "cpu")
    zero = init_pending_state(tparams, cfg)
    got = _flat(zero)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(g, int):
            assert w.dtype == np.int32 and w.shape == () and g == int(w), k
        else:
            assert tuple(g.shape) == w.shape and str(g.dtype).removeprefix("torch.") == \
                w.dtype.name, k
    state = galore(cfg, b1=B1, b2=B2, eps=EPS, external_refresh=True).init(tparams)
    pending = refresh_projectors_pending(_t(grads), state, cfg)
    assert sorted(_flat(pending)) == sorted(got)
    assert pending["flag"] == {"a": 1, "b": 1}  # force-all: every galore leaf


def _flat_jax(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(str(getattr(k, "key", k)) for k in p): v for p, v in flat}


def test_pending_flags_follow_staggered_dueness():
    """Flags at steps 1-3 under stagger equal JAX's; an unflagged leaf passes
    the active projector through."""
    params, grads = _toy()
    jcfg, cfg = _cfgs(refresh_stagger=True)
    jstate = jgal.galore(jax_scale_by_adam(), jcfg, external_refresh=True).init(params)
    tparams = params_from_numpy(params, "cpu")
    state = galore(cfg, b1=B1, b2=B2, eps=EPS, external_refresh=True).init(tparams)
    state = refresh_projectors(_t(grads), state, cfg)  # a nonzero active P
    for step in (1, 2, 3):
        jp = jgal.refresh_projectors_pending(grads, jstate, jcfg, step=step)
        p = refresh_projectors_pending(_t(grads), state, cfg, step=step)
        assert p["flag"] == {k: int(v) for k, v in jp["flag"].items()}, step
        for k, f in p["flag"].items():
            assert (p["proj"][k] is state["proj"][k]) == (not f)


@pytest.mark.parametrize("kw", [{}, {"refresh_stagger": True}, {"adaptive_t": True},
                                {"quant": dict(projectors="int4", min_quant_size=0)}],
                         ids=["plain", "stagger", "adaptive", "int4p"])
def test_dispatch_plus_swap_matches_synchronous_refresh_bitwise(kw):
    """refresh_projectors_pending + swap_pending_state equals
    refresh_projectors bit for bit (projectors and schedule), and the swap
    leaves the moments, step and key untouched (no re-projection)."""
    params, grads = _toy()
    _, cfg = _cfgs(**kw)
    tparams = params_from_numpy(params, "cpu")
    opt = galore(cfg, b1=B1, b2=B2, eps=EPS, external_refresh=True)
    state = opt.init(tparams)
    g = _t(grads)
    for step in (None, 0, 1, 2, 4):
        pending = refresh_projectors_pending(g, state, cfg, step=step)
        swapped = swap_pending_state(tparams, state, pending, cfg)
        direct = refresh_projectors(g, state, cfg, step=step)
        _assert_bitwise(swapped, direct)
        assert swapped["inner"] is state["inner"]
        _, state = opt.update(g, direct, tparams)
        g = tree_map(lambda x: 0.5 * x + 0.1, g)


@pytest.mark.parametrize("case", ["fp32", "int8", "fp32-stagger", "int8-int4p"])
def test_reprojected_moments_match_jax(case):
    """JAX's state after two updates and JAX's pending buffer, bridged over:
    the port's swap installs the same P (bit for bit) and rotates the moments
    as JAX's swap does — M by Q = P_newᵀP_old, V by Q∘Q — fp32 within
    1e-5·max, int8 codes at most one apart with scales within 1e-5; an
    unflagged leaf keeps its moments bit for bit."""
    params, grads = _toy(1)
    kw = dict(reproject_moments=True, refresh_stagger="stagger" in case)
    if "int8" in case:
        kw["quant"] = dict(moments="int8", projectors="int4" if "int4p" in case else "fp32",
                           min_quant_size=0)
    jcfg, cfg = _cfgs(**kw)
    jopt = jgal.galore(jax_scale_by_adam(), jcfg, external_refresh=True, fused_adam=True,
                       b1=B1, b2=B2, eps=EPS)
    jstate = jopt.init(params)
    jstate = jgal.refresh_projectors(grads, jstate, jcfg)
    for i in range(2):
        _, jstate = jopt.update(jax.tree_util.tree_map(lambda g: g * (1 + i), grads), jstate,
                                params)
    grads2 = jax.tree_util.tree_map(lambda g: -0.5 * g + 0.3, grads)
    step = 2 if "stagger" in case else None  # offsets 0 and 2: only "b" is due at 2
    jpending = jgal.refresh_projectors_pending(grads2, jstate, jcfg, step=step)
    jswapped = jgal.swap_pending_state(params, jstate, jpending, jcfg)

    state = galore_state_from_numpy(_np_tree(jstate), "cpu")
    pending = pending_from_numpy(_np_tree(jpending), "cpu")
    swapped = swap_pending_state(params_from_numpy(params, "cpu"), state, pending, cfg)
    flags = pending["flag"]
    assert sum(flags.values()) == (1 if "stagger" in case else 2)
    for k in params:
        want_p = _np_tree(jswapped["proj"][k])
        got_p = tree_map(lambda t: t.numpy(), swapped["proj"][k])
        for w, g in zip(jax.tree_util.tree_leaves(want_p), tree_leaves(got_p)):
            np.testing.assert_array_equal(g, w)
        for name in ("m", "v"):
            want, got = _np_tree(jswapped["inner"][name][k]), swapped["inner"][name][k]
            if not flags[k]:
                _assert_bitwise(got, state["inner"][name][k])
                continue
            if isinstance(got, dict):
                q = got["q"].numpy().astype(np.int16) - want["q"].astype(np.int16)
                assert np.abs(q).max() <= 1, (k, name)
                np.testing.assert_allclose(got["scale"].numpy(), want["scale"], rtol=1e-5,
                                           atol=0, err_msg=f"{k} {name}")
            else:
                np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                           atol=1e-5 * np.abs(want).max(), err_msg=f"{k} {name}")
                if name == "v":
                    assert float(got.min()) >= 0.0


class _Bridged:
    """The JAX pipeline's batches as CPU tensors."""

    def __init__(self, jdata):
        self.jdata = jdata

    def batch(self, step):
        b = self.jdata.batch(step)
        return {"tokens": torch.tensor(np.asarray(b["tokens"]), dtype=torch.int64),
                "targets": torch.tensor(np.asarray(b["targets"]), dtype=torch.int64),
                "loss_mask": torch.tensor(np.asarray(b["loss_mask"]))}


def test_async_stagger_20step_trajectory_matches_jax(tmp_path):
    """20 steps of fp32 fused GaLore with the async staggered refresh and
    moment re-projection: the port's launcher against the reference's
    AsyncRefreshDriver and train step on one device (no mesh), from the
    same weights and batches: losses within 5e-2."""
    jcfg = jax_get_config("llama_60m", smoke=True)
    g = dict(rank=8, update_freq=4, refresh_stagger=True, reproject_moments=True)
    common = dict(optimizer="adamw", galore_refresh_async=True, galore_fused_adam=True,
                  total_steps=20, warmup_steps=2)
    jtc = JTrainConfig(galore=JGaLoreConfig(**g), **common)
    step_fn, jopt = jax_make_train_step(jcfg, jtc, None)
    step_fn = jax.jit(step_fn)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(_np_tree(jparams), "cpu")
    jstate = jopt.init(jparams)
    driver = JAsyncRefreshDriver(jcfg, jtc, None)
    jdata = JSyntheticC4(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=64, batch_per_host=4))
    want = []
    for s in range(20):
        b = jdata.batch(s)
        jstate = driver.maybe_refresh(jparams, jstate, b, s)
        jparams, jstate, metrics = step_fn(jparams, jstate, b)
        want.append(float(metrics["loss"]))

    got = []
    tc = TrainConfig(galore=GaLoreConfig(**g), **common)
    train_loop(RunConfig(steps=20, batch_per_host=4, seq_len=64, log_every=100, ckpt_every=0,
                         ckpt_dir=str(tmp_path), device="cpu"),
               tc, cfg=get_config("llama_60m", smoke=True), params=tparams, data=_Bridged(jdata),
               on_step=lambda s, m: got.append(float(m["loss"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def _sync_emulation(cfg, tc, steps, seq=32, batch=2):
    """The async driver's schedule run in the main thread, step by step:
    swap the pending buffer at the boundary, refresh synchronously at step
    0, and at a due step compute the pending buffer from the previous
    batch's gradient at the current params, before the train step."""
    params = TM.init_params(cfg, seed=tc.seed, device="cpu")
    step_fn, opt = make_train_step(cfg, tc)
    refresh, pend_fn, swap = (make_refresh_step(cfg, tc), make_async_refresh_step(cfg, tc),
                              make_swap_step(cfg, tc))
    idx = galore_state_index(tc)
    offsets = galore_due_offsets(params, tc)
    T = tc.galore.update_freq
    data = SyntheticC4(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_per_host=batch),
                       device="cpu")
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
            sub = {k: v for k, v in state[idx].items() if k != "inner"}
            pending = pend_fn(params, sub, stale, s)
        params, state, m = step_fn(params, state, b)
        losses.append(float(m["loss"]))
    if pending is not None:
        state = swap(state, pending, params)
    return losses, params, state


@pytest.mark.parametrize("quant", [None, dict(moments="int8", projectors="int4")],
                         ids=["fp32", "8bit"])
def test_driver_equals_synchronous_emulation_bitwise(tmp_path, quant):
    """The launcher's AsyncRefreshDriver (its refresh on a host thread)
    equals the same schedule run synchronously in the main thread, bit for
    bit: every loss, every param and every leaf of the optimizer state."""
    cfg = get_config("llama_60m", smoke=True)
    g = GaLoreConfig(rank=8, update_freq=4, refresh_stagger=True, reproject_moments=True,
                     quant=QuantPolicy(**quant) if quant else QuantPolicy())
    tc = TrainConfig(optimizer="adam8bit" if quant else "adamw", galore=g,
                     galore_refresh_async=True, galore_fused_adam=True, total_steps=9,
                     warmup_steps=2, weight_decay=0.01)
    want_losses, want_params, want_state = _sync_emulation(cfg, tc, 9)
    got = []
    params, state, _, _ = train_loop(
        RunConfig(steps=9, batch_per_host=2, seq_len=32, log_every=100, ckpt_every=0,
                  ckpt_dir=str(tmp_path), device="cpu"),
        tc, cfg=cfg, on_step=lambda s, m: got.append(float(m["loss"])))
    assert got == want_losses
    _assert_bitwise(params, want_params)
    _assert_bitwise(state, want_state)


def test_refresh_thread_failure_fails_the_run(tmp_path, monkeypatch):
    """An exception in the refresh thread re-raises in the training loop at
    the swap; nothing catches it."""
    import repro_torch.launch.train as launcher

    def boom(*a, **k):
        raise RuntimeError("refresh thread failed")

    monkeypatch.setattr(launcher, "refresh_projectors_pending", boom)
    tc = TrainConfig(galore=GaLoreConfig(rank=8, update_freq=4, refresh_stagger=True),
                     galore_refresh_async=True, total_steps=4, warmup_steps=1)
    with pytest.raises(RuntimeError, match="refresh thread failed"):
        train_loop(RunConfig(steps=4, batch_per_host=2, seq_len=32, log_every=100,
                             ckpt_every=0, ckpt_dir=str(tmp_path), device="cpu"), tc)
