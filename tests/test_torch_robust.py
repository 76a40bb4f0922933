"""The port's fault tolerance (repro_torch/robust/, the guarded step, the
launcher's rollback), the rest of core/projector.py and the loss's metrics,
against the JAX package.

1. the guard's arithmetic against repro.robust.guard on the same loss
   sequences, bit for bit; fault specs and injection against
   repro.robust.faults;
2. the guarded step: with an identity fault it is the unguarded run bit for
   bit; a faulted step is a bitwise no-op on params and every state leaf;
3. the launcher: a rollback lands on the fault-free run, walks past a
   corrupt checkpoint, restarts from init with none; a spent budget raises
   TrainingFailure; the CLI's refusals and its chaos drive;
4. the randomized and Newton–Schulz projectors against JAX's on the same G
   and sketch, the SVD's randomized fallback and the guard_refresh gate;
5. the flat int4 codec bit for bit, and loss_fn's aux_loss and ppl_proxy.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.projector import compute_projector as jax_compute_projector  # noqa: E402
from repro.core.subspace import projector_or_fallback as jax_projector_or_fallback  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.quant import codec as jcodec  # noqa: E402
from repro.robust import FaultInjector as JFaultInjector  # noqa: E402
from repro.robust import init_guard_state as jax_init_guard_state  # noqa: E402
from repro.robust.guard import global_grad_norm as jax_global_grad_norm  # noqa: E402
from repro.robust.guard import guard_step as jax_guard_step  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core import subspace  # noqa: E402
from repro_torch.core.galore import galore  # noqa: E402
from repro_torch.core.projector import (  # noqa: E402
    compute_projector,
    prng_key,
    sketch_generator,
    sketch_width,
    subspace_overlap,
)
from repro_torch.distributed.step import make_train_step  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.quant import QuantPolicy, codec  # noqa: E402
from repro_torch.robust import (  # noqa: E402
    FaultInjector,
    TrainingFailure,
    identity_fault,
    init_guard_state,
    parse_fault,
)
from repro_torch.robust.guard import global_grad_norm, guard_step  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402
from test_torch_checkpoint import _assert_trees_bitwise, _flat  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

NAN, INF = float("nan"), float("inf")
GUARD = dict(zmax=6.0, warmup=3, ema=0.9)


# ---------------------------------------------------------------------------
# 1. the guard's arithmetic, the fault specs
# ---------------------------------------------------------------------------

SEQUENCES = {
    "spike_after_warmup": [(5.0, 1.0), (5.1, 1.0), (4.9, 1.0), (5.0, 1.0), (1e4, 1.0),
                           (5.05, 1.0), (4.97, 2.0), (5.3, 1.0)],
    "spike_in_warmup": [(1e4, 1.0), (5.0, 1.0), (5.2, 1.0), (4.8, 1.0), (5.0, 1.0)],
    "nonfinite": [(5.0, 1.0), (NAN, 1.0), (INF, 1.0), (5.1, NAN), (5.2, INF), (4.9, 1.0),
                  (-INF, 1.0), (5.0, 1.0)],
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_guard_matches_jax_bitwise(name):
    """Verdict and state after every step of a loss sequence equal the
    reference's: f32 EMA mean and variance bit for bit, int32 counts."""
    jg, tg = jax_init_guard_state(), init_guard_state("cpu")
    for loss, gnorm in SEQUENCES[name]:
        jok, jg = jax_guard_step(jg, jnp.float32(loss), jnp.float32(gnorm), **GUARD)
        ok, tg = guard_step(tg, torch.tensor(loss), torch.tensor(gnorm), **GUARD)
        assert bool(ok) == bool(jok), (name, loss, gnorm)
        for k in ("mean", "var", "count", "skips"):
            want = np.asarray(jg[k])
            assert tg[k].numpy().dtype == want.dtype
            np.testing.assert_array_equal(tg[k].numpy(), want, err_msg=f"{name} {k}")


def test_global_grad_norm_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((2, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(70).astype(np.float32)}}
    want = float(jax_global_grad_norm(jax.tree_util.tree_map(jnp.asarray, tree)))
    got = global_grad_norm(tree_map(torch.from_numpy, tree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("spec", ["nan_loss@3", "spike_loss@12*4", " corrupt_ckpt@8 ",
                                  "nan_loss", "nan_loss@", "frobnicate@3", "nan_loss@3*"])
def test_parse_fault_matches_jax(spec):
    from repro.robust import parse_fault as jax_parse_fault

    try:
        want = jax_parse_fault(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_fault(spec)
        return
    got = parse_fault(spec)
    assert (got.kind, got.step, got.count) == (want.kind, want.step, want.count)


def test_injector_matches_jax():
    """The same specs fire the same traced inputs (once per (spec, step),
    also on a replay) and the same host triggers as the reference's."""
    specs = ["nan_loss@3", "nan_grad@5*2", "inf_loss@6", "spike_loss@9", "corrupt_ckpt@4",
             "kill_save@7"]
    mine, ref = FaultInjector(specs), JFaultInjector(specs)
    assert mine.needs_traced_hooks and FaultInjector(["kill_save@1"]).needs_traced_hooks is False
    for step in [0, 2, 3, 3, 4, 5, 6, 6, 5, 7, 8, 9, 9, 10]:
        got, want = mine.traced_fault(step), ref.traced_fault(step)
        for k in ("loss_add", "grad_scale"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=(step, k))
        for kind in ("corrupt_ckpt", "kill_save"):
            assert mine.take(kind, step) == ref.take(kind, step), (step, kind)


# ---------------------------------------------------------------------------
# 2. the guarded step
# ---------------------------------------------------------------------------

_G = dict(rank=16, update_freq=4, scale=0.25)
FORMS = {
    "adamw": dict(),
    "galore_fused": dict(galore=GaLoreConfig(**_G), galore_fused_adam=True),
    "galore_8bit": dict(optimizer="adam8bit", galore_fused_adam=True, galore=GaLoreConfig(
        **_G, quant=QuantPolicy(moments="int8", projectors="int4"))),
}


def _tc(form="galore_fused", **kw):
    return TrainConfig(**{"lr": 1e-3, "weight_decay": 0.01, "total_steps": 12,
                          "warmup_steps": 2, **FORMS[form], **kw})


def _setup(tc):
    cfg = get_config("llama_60m", smoke=True)
    params = TM.init_params(cfg, seed=0, device="cpu")
    step, opt = make_train_step(cfg, tc)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 32),
                                     generator=torch.Generator().manual_seed(0))}
    return params, opt.init(params), step, batch


def _snapshot(tree):
    return {k: v.copy() for k, v in _flat(tree).items()}


@pytest.mark.parametrize("kind", ["nan_loss", "inf_loss", "spike_loss", "nan_grad"])
@pytest.mark.parametrize("form", ["galore_fused", "galore_8bit"])
def test_faulted_step_is_bitwise_noop(form, kind):
    """A rejected step leaves params, moments (codes and scales), projectors,
    the schedule's count and the galore step bit for bit as they were; the
    next clean step proceeds from them."""
    params, state, step, batch = _setup(_tc(form, anomaly_guard=True, fault_hooks=True,
                                            guard_warmup=1))
    guard = init_guard_state("cpu")
    params, state, guard, m = step(params, state, guard, batch, identity_fault())
    assert int(m["guard_ok"]) == 1
    before = _snapshot({"p": params, "s": state})
    inj = FaultInjector([f"{kind}@1"])
    params, state, guard, m = step(params, state, guard, batch, inj.traced_fault(1))
    assert int(m["guard_ok"]) == 0 and int(m["guard_skips"]) == 1
    _assert_trees_bitwise(_flat({"p": params, "s": state}), before)
    params, state, guard, m = step(params, state, guard, batch, inj.traced_fault(2))
    assert int(m["guard_ok"]) == 1 and state[1]["step"] == 2
    assert any(not np.array_equal(v, before[k]) for k, v in _flat({"p": params}).items())


def _loop(ckpt_dir, form="galore_fused", steps=12, faults=None, ckpt_every=4, params=None,
          **tc_kw):
    losses = []
    run = RunConfig(steps=steps, batch_per_host=2, seq_len=32, ckpt_dir=str(ckpt_dir),
                    ckpt_every=ckpt_every, log_every=100, device="cpu")
    p, s, _, _ = train_loop(run, _tc(form, **tc_kw), params=params, faults=faults,
                            on_step=lambda st, m: losses.append((st, float(m["loss"]))))
    return p, s, losses


@pytest.mark.parametrize("form", list(FORMS))
def test_guarded_run_equals_unguarded(tmp_path, form):
    """The guard with the identity fault input changes nothing: every loss,
    parameter and state leaf of a 12-step run equal the unguarded run's."""
    p0, s0, l0 = _loop(tmp_path / "off", form, ckpt_every=0)
    p1, s1, l1 = _loop(tmp_path / "on", form, ckpt_every=0, anomaly_guard=True,
                       fault_hooks=True)
    assert l1 == l0
    _assert_trees_bitwise(_flat({"p": p1, "s": s1}), _flat({"p": p0, "s": s0}))


def test_rollback_recovers_fault_free_run(tmp_path, capsys):
    """Three poisoned gradients in a row trip the escalation: the run
    restores step 4 and replays 5-7 clean (a traced fault fires once),
    landing on the fault-free run bit for bit."""
    p0, s0, l0 = _loop(tmp_path / "ref", anomaly_guard=True)
    p1, s1, l1 = _loop(tmp_path / "faulty", anomaly_guard=True, faults=["nan_grad@5*3"])
    out = capsys.readouterr().out
    assert "[recover] rollback 1/2: restored step 4, resuming at step 5" in out
    assert out.count("[guard] anomalous step") == 3
    assert [s for s, _ in l1] == [0, 1, 2, 3, 4, 5, 6] + list(range(5, 12))
    assert l1[7:] == l0[5:]
    _assert_trees_bitwise(_flat({"p": p1, "s": s1}), _flat({"p": p0, "s": s0}))


def test_rollback_walks_past_corrupt_checkpoint(tmp_path, capsys):
    """The newest checkpoint (step 6) is torn after it was written: the
    guarded run's crc check refuses it and the rollback restores step 4. A
    kill mid-save leaves tmp litter that a new manager collects."""
    _loop(tmp_path, anomaly_guard=True, ckpt_every=2, steps=10, recover_max_skips=2,
          faults=["corrupt_ckpt@6", "nan_grad@7*2", "kill_save@8"])
    out = capsys.readouterr().out
    assert "restored step 4, resuming at step 5" in out
    litter = [p for p in tmp_path.iterdir() if ".tmp_" in p.name]
    assert len(litter) == 1
    launcher.CheckpointManager(str(tmp_path))
    assert not litter[0].exists()


def test_rollback_without_checkpoint_restarts_from_init(tmp_path, capsys):
    """With nothing on disk a rollback restarts from the initial params (the
    ones the caller passed), and the clean replay is the fault-free run."""
    params = TM.init_params(get_config("llama_60m", smoke=True), seed=3, device="cpu")
    init = tree_map(lambda t: t.detach().numpy().copy(), params)
    p0, _, l0 = _loop(tmp_path / "ref", steps=6, ckpt_every=0, anomaly_guard=True,
                      params=params_from_numpy(init, "cpu"))
    p1, _, l1 = _loop(tmp_path / "faulty", steps=6, ckpt_every=0, anomaly_guard=True,
                      params=params_from_numpy(init, "cpu"), faults=["nan_loss@1*2"],
                      recover_max_skips=2)
    assert "restored step None, resuming at step 0" in capsys.readouterr().out
    assert l1[-6:] == l0
    _assert_trees_bitwise(_flat(p1), _flat(p0))


def test_exhausted_rollback_budget_raises(tmp_path):
    with pytest.raises(TrainingFailure):
        _loop(tmp_path, anomaly_guard=True, steps=20, faults=["nan_grad@5*30"],
              recover_max_skips=2, recover_max_rollbacks=2)


def test_refusals(tmp_path):
    """Traced faults need the guard; the guard has no fused-apply variant (as
    in the reference)."""
    from repro.configs.base import GaLoreConfig as JGaLoreConfig
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.distributed.step import make_train_step as jax_make_train_step

    with pytest.raises(ValueError, match="anomaly_guard"):
        _loop(tmp_path, faults=["nan_loss@1"])
    cfg = get_config("llama_60m", smoke=True)
    with pytest.raises(ValueError, match="no guarded variant"):
        make_train_step(cfg, _tc(anomaly_guard=True, galore_fused_apply=True))
    with pytest.raises(ValueError, match="no guarded variant"):
        jax_make_train_step(jax_get_config("llama_60m", smoke=True),
                            JTrainConfig(galore=JGaLoreConfig(rank=16), galore_fused_adam=True,
                                         galore_fused_apply=True, anomaly_guard=True))


_CLI = ["--steps", "10", "--seq", "32", "--batch", "2", "--galore-rank", "16", "--galore-t", "4",
        "--galore-fused", "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("extra", [["--inject-fault", "nan_grad@3"],
                                   ["--anomaly-guard", "--inject-fault", "nan_loss@x"],
                                   ["--anomaly-guard", "--galore-fused-apply"]])
def test_cli_refusals(tmp_path, extra):
    with pytest.raises(SystemExit) as e:
        launcher.main(_CLI + ["--ckpt-dir", str(tmp_path)] + extra)
    assert e.value.code == 2


def test_cli_chaos_drive(tmp_path, capsys):
    """--anomaly-guard --inject-fault nan_grad@5*3 --ckpt-every 4 skips three
    steps, rolls back to step 4 and finishes with finite losses."""
    launcher.main(_CLI + ["--ckpt-dir", str(tmp_path), "--ckpt-every", "4", "--anomaly-guard",
                          "--inject-fault", "nan_grad@5*3"])
    out = capsys.readouterr().out
    assert "[recover] rollback 1/2: restored step 4" in out
    losses = [float(line.split()[4]) for line in out.splitlines()
              if line.startswith("[train] step")]
    assert len(losses) == 12 and all(np.isfinite(losses))  # 0-6, then 5-9 replayed


# ---------------------------------------------------------------------------
# 4. the projector methods
# ---------------------------------------------------------------------------


def _decaying(shape, seed):
    """G with a fast-decaying spectrum, so the top subspace is well defined."""
    rng = np.random.default_rng(seed)
    lead, (m, n) = shape[:-2], shape[-2:]
    k = min(m, n)
    U = np.linalg.qr(rng.standard_normal(lead + (m, k)))[0]
    W = np.linalg.qr(rng.standard_normal(lead + (n, k)))[0]
    return ((U * np.logspace(1, -3, k)) @ np.swapaxes(W, -1, -2)).astype(np.float32)


@pytest.mark.parametrize("method,shape,rank", [
    ("randomized", (64, 96), 8), ("newton_schulz", (64, 96), 8),
    ("randomized", (2, 72, 130), 16), ("newton_schulz", (2, 72, 130), 16),
    ("randomized", (40, 30), 8)])
def test_randomized_projectors_match_jax(method, shape, rank):
    """Same G, same sketch (JAX's, handed across): the port's P spans the
    reference's subspace (overlap > 0.999) with orthonormal columns (a wide,
    a stacked and a tall G)."""
    G = _decaying(shape, 1)
    key = jax.random.PRNGKey(7)
    m, n = shape[-2:]
    omega = np.asarray(jax.random.normal(key, (n, sketch_width(rank, m, n)), jnp.float32))
    jfn = jax.jit(jax_compute_projector, static_argnums=1, static_argnames="method")
    want = np.asarray(jfn(jnp.asarray(G), rank, method=method, key=key))
    got = compute_projector(torch.from_numpy(G), rank, method=method, sketch=torch.tensor(omega))
    assert got.shape == want.shape and got.dtype == torch.float32
    overlap = subspace_overlap(got, torch.tensor(want))
    assert float(overlap.min()) > 0.999, overlap
    gram = got.transpose(-1, -2) @ got
    torch.testing.assert_close(gram, torch.eye(rank).expand_as(gram), atol=1e-3, rtol=0)


@pytest.mark.parametrize("method", ["randomized", "newton_schulz"])
def test_galore_refresh_with_randomized_method(method):
    """galore(projector=…) refreshes from a sketch drawn from (key, step):
    the projectors span the exact SVD's subspace, and the draw is the
    sketch_generator(key, step) one."""
    cfg = GaLoreConfig(rank=8, update_freq=4, projector=method)
    params = {"w": torch.zeros(48, 96), "v": torch.zeros(2, 96, 40)}
    grads = {"w": torch.from_numpy(_decaying((48, 96), 2)),
             "v": torch.from_numpy(_decaying((2, 96, 40), 3))}
    opt = galore(cfg, b1=0.9, b2=0.999, eps=1e-8, seed=5)
    state = opt.init(params)
    assert torch.equal(state["key"], prng_key(5)) and state["key"].dtype == torch.uint32
    _, state = opt.update(grads, state, params)
    exact = compute_projector(grads["w"], 8)
    assert float(subspace_overlap(state["proj"]["w"], exact)) > 0.999
    exact_v = compute_projector(grads["v"].transpose(-1, -2), 8)
    assert float(subspace_overlap(state["proj"]["v"], exact_v).min()) > 0.999
    again = compute_projector(grads["w"], 8, method=method,
                              generator=sketch_generator(prng_key(5), 0))
    assert torch.equal(state["proj"]["w"], again)


def test_projector_or_fallback_matches_jax():
    """A finite primary passes through; a NaN one (a failed SVD) gives the
    randomized projector, spanning the reference fallback's subspace."""
    G = _decaying((32, 64), 4)
    good = np.zeros((32, 8), np.float32)
    good[:8] = np.eye(8)
    got = subspace.projector_or_fallback(torch.from_numpy(good), torch.from_numpy(G), 8,
                                         sketch_generator(), 1)
    assert torch.equal(got, torch.from_numpy(good))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(jax_projector_or_fallback, static_argnums=(2, 4))(
        jnp.full((32, 8), jnp.nan), jnp.asarray(G), 8, key, 1))
    got = subspace.projector_or_fallback(torch.full((32, 8), NAN), torch.from_numpy(G), 8,
                                         sketch_generator(), 1)
    assert torch.isfinite(got).all()
    assert float(subspace_overlap(got, torch.tensor(want))) > 0.999


def test_guarded_svd_falls_back_on_linalg_error(monkeypatch):
    """Under guard_refresh an SVD that raises LinAlgError gives the
    randomized projector; without the guard the error propagates."""
    real = subspace.compute_projector

    def failing(G, rank, *, method="svd", **kw):
        if method == "svd":
            raise torch.linalg.LinAlgError("the algorithm failed to converge")
        return real(G, rank, method=method, **kw)

    monkeypatch.setattr(subspace, "compute_projector", failing)
    g = torch.from_numpy(_decaying((48, 96), 5))
    plan = subspace.SubspacePlan(True, "left", rank=8, refresh_period=4)
    P = subspace.compute_leaf_projector(g, plan, GaLoreConfig(rank=8, guard_refresh=True))
    assert float(subspace_overlap(P, real(g, 8))) > 0.999
    with pytest.raises(torch.linalg.LinAlgError):
        subspace.compute_leaf_projector(g, plan, GaLoreConfig(rank=8))


def test_guard_refresh_skips_nonfinite_gradient():
    """Under guard_refresh one non-finite gradient element makes the whole
    refresh a no-op (every projector kept); a clean gradient refreshes."""
    cfg = GaLoreConfig(rank=8, update_freq=4, guard_refresh=True)
    params = {"a": torch.zeros(24, 64), "b": torch.zeros(48, 32)}
    grads = {"a": torch.from_numpy(_decaying((24, 64), 6)),
             "b": torch.from_numpy(_decaying((48, 32), 7))}
    mgr = subspace.SubspaceManager(cfg)
    plans = mgr.plans(params)
    proj = galore(cfg, b1=0.9, b2=0.999, eps=1e-8).init(params)["proj"]
    bad = dict(grads, a=grads["a"].clone().index_put_((torch.tensor(0), torch.tensor(0)),
                                                      torch.tensor(NAN)))
    assert not bool(subspace.tree_all_finite(bad)) and bool(subspace.tree_all_finite(grads))
    kept, _ = mgr.refresh_tree(bad, proj, None, plans, step=0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(kept), tree_leaves(proj)))
    new, _ = mgr.refresh_tree(grads, proj, None, plans, step=0)
    assert all(torch.isfinite(p).all() and p.abs().sum() > 0 for p in tree_leaves(new))


# ---------------------------------------------------------------------------
# 5. the flat int4 codec, the loss's metrics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7,), (300,), (2, 64, 16)])
def test_flat_int4_codec_bitwise(shape):
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    jq, js = jax.jit(jcodec.quantize4)(jnp.asarray(x))
    q, s = codec.quantize4(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    want = np.asarray(jax.jit(jcodec.dequantize4, static_argnums=2)(jq, js, shape))
    np.testing.assert_array_equal(codec.dequant4_state({"q": q, "scale": s}, shape).numpy(), want)


def test_loss_metrics_match_jax():
    """loss_fn returns the reference's {"loss", "aux_loss", "ppl_proxy"}:
    aux_loss a zero f32 scalar for the dense family, ppl_proxy
    exp(min(loss, 20)), within 1e-5 of JAX's on one batch."""
    jcfg = jax_get_config("llama_60m", smoke=True)
    jparams = jax.jit(lambda k: JM.init_params(jcfg, k))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    _, want = jax.jit(lambda p, t: JM.loss_fn(jcfg, p, {"tokens": t}))(jparams, tokens)
    cfg = get_config("llama_60m", smoke=True)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    _, got = TM.loss_fn(cfg, params, {"tokens": torch.from_numpy(tokens).long()})
    assert sorted(got) == ["aux_loss", "loss", "ppl_proxy"]
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].shape == () and not got[k].requires_grad
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=0, atol=1e-5)
    assert float(got["aux_loss"]) == float(want["aux_loss"]) == 0.0
    np.testing.assert_allclose(float(got["ppl_proxy"]), float(want["ppl_proxy"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# 6. the async refresh's poisoned buffer and the post-rollback resync
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("poison", ["every-leaf", "one-leaf"])
def test_poisoned_pending_rejected_per_leaf_as_jax(poison):
    """corrupt_pending (poison_pending) NaNs the in-flight P_next, flags
    kept. Under guard_refresh the swap rejects each poisoned leaf — its P,
    schedule scalars and moments stay — and takes each healthy one, leaf for
    leaf as JAX's swap on the same buffer; the poisoned buffers are JAX's
    bit for bit."""
    from repro.configs.base import GaLoreConfig as JGaLoreConfig
    from repro.core import galore as jgal
    from repro.optim.adam import scale_by_adam as jax_scale_by_adam
    from repro_torch.bridge import galore_state_from_numpy, pending_from_numpy, pending_to_numpy
    from repro_torch.core.galore import swap_pending_state

    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((24, 64)).astype(np.float32),
              "b": rng.standard_normal((48, 32)).astype(np.float32)}
    grads = {k: rng.standard_normal(p.shape).astype(np.float32) for k, p in params.items()}
    kw = dict(rank=8, update_freq=4, adaptive_t=True, reproject_moments=True,
              guard_refresh=True)
    jcfg, cfg = JGaLoreConfig(**kw), GaLoreConfig(**kw)
    jopt = jgal.galore(jax_scale_by_adam(), jcfg, external_refresh=True, fused_adam=True,
                       b1=0.9, b2=0.999, eps=1e-8)
    jstate = jgal.refresh_projectors(grads, jopt.init(params), jcfg)
    _, jstate = jopt.update(grads, jstate, params)
    jpending = jgal.refresh_projectors_pending(
        jax.tree_util.tree_map(lambda g: 0.3 - g, grads), jstate, jcfg, step=4)
    pending = pending_from_numpy(jax.tree_util.tree_map(np.asarray, jpending), "cpu")
    if poison == "every-leaf":
        jpois = JFaultInjector.poison_pending(jpending)
        pois = FaultInjector.poison_pending(pending)
        _assert_trees_bitwise(_flat(pending_to_numpy(pois)),
                              _flat(jax.tree_util.tree_map(np.asarray, jpois)))
    else:
        jpois = {**jpending, "proj": {**jpending["proj"],
                                      "a": jnp.full_like(jpending["proj"]["a"], jnp.nan)}}
        pois = {**pending, "proj": {**pending["proj"],
                                    "a": torch.full_like(pending["proj"]["a"], NAN)}}
    assert pois["flag"] == {"a": 1, "b": 1}
    jswapped = jgal.swap_pending_state(params, jstate, jpois, jcfg)
    state = galore_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    swapped = swap_pending_state(params_from_numpy(params, "cpu"), state, pois, cfg)
    for k in params:
        took_jax = not np.array_equal(np.asarray(jswapped["proj"][k]),
                                      np.asarray(jstate["proj"][k]))
        took = swapped["proj"][k] is not state["proj"][k]
        assert took == took_jax == (poison == "one-leaf" and k == "b"), k
        assert torch.isfinite(swapped["proj"][k]).all()
        for name in ("period", "next"):
            assert swapped["schedule"][name][k] == int(jswapped["schedule"][name][k]), (k, name)
        if not took:
            assert swapped["schedule"]["next"][k] == state["schedule"]["next"][k]
            for name in ("m", "v"):
                assert swapped["inner"][name][k] is state["inner"][name][k]


def test_corrupt_pending_fault_fires_and_run_stays_finite(tmp_path, capsys):
    """--inject-fault corrupt_pending@3 with the async refresh and the guard:
    the launcher poisons the buffer dispatched at step 3, the swap at step 4
    rejects every leaf of it (each keeps its P and retries at its next due
    step), and the run finishes with finite losses and projectors."""
    p, s, losses = _loop(tmp_path, steps=8, ckpt_every=0, anomaly_guard=True,
                         faults=["corrupt_pending@3"], galore_refresh_async=True,
                         galore=GaLoreConfig(**_G, refresh_stagger=True, guard_refresh=True))
    assert "[faults] poisoning in-flight pending buffer at step 3" in capsys.readouterr().out
    assert len(losses) == 8 and all(np.isfinite([x for _, x in losses]))
    assert all(torch.isfinite(t).all() for t in tree_leaves(s[1]["proj"]))


def test_recover_resync_runs_a_force_all_refresh(tmp_path, capsys, monkeypatch):
    """--recover-resync with the external refresh: after the rollback to step
    4 one refresh recomputes every projector from the restored params and
    step 5's batch (phase 0 of the stagger: every leaf due) — bit for bit
    that refresh recomputed from the checkpoint — before step 5 replays."""
    calls = []
    make = launcher.make_refresh_step

    def spying(cfg, tc):
        fn = make(cfg, tc)

        def refresh(params, opt_state, batch, step=None):
            out = fn(params, opt_state, batch, step)
            calls.append((step, opt_state[1]["proj"], out[1]["proj"]))
            return out

        return refresh

    monkeypatch.setattr(launcher, "make_refresh_step", spying)
    g = GaLoreConfig(**_G, refresh_stagger=True, guard_refresh=True)
    _loop(tmp_path, steps=8, anomaly_guard=True, faults=["nan_grad@5*3"],
          galore_external_refresh=True, recover_resync=True, galore=g)
    out = capsys.readouterr().out
    assert "[recover] resync: force-all refresh at step 5" in out
    steps = [c[0] for c in calls]
    assert steps == [0, 1, 2, 3, 4, 5, 6, 7, 0, 5, 6, 7]  # the resync after step 7's call
    _, before, after = calls[8]
    assert all(not torch.equal(a, b) for a, b in zip(tree_leaves(after), tree_leaves(before))
               if a.ndim)  # every galore leaf recomputed
    tc = _tc(anomaly_guard=True, galore_external_refresh=True, galore=g)
    cfg = get_config("llama_60m", smoke=True)
    _, opt = make_train_step(cfg, tc)
    params = TM.init_params(cfg, seed=0, device="cpu")
    restored = launcher.CheckpointManager(str(tmp_path)).restore(
        4, {"params": params, "opt_state": opt.init(params)})
    from repro_torch.data.pipeline import DataConfig, SyntheticC4

    batch = SyntheticC4(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_per_host=2),
                        device="cpu").batch(5)
    want = make(cfg, tc)(restored["params"], restored["opt_state"], batch, 0)[1]["proj"]
    _assert_trees_bitwise(_flat(after), _flat(want))
