"""The paper's baselines in the port against the JAX package on the same
inputs: Adafactor and SGD's momentum ``trace`` (five steps, f32 and bf16
leaves), GaLore over a non-Adam inner transform (the composable path, f32
and int4 P), the factory's builds and refusals, LoRA / ReLoRA / low-rank
(``optim/lowrank.py``, A handed across from JAX), a 20-step trajectory of
each of adafactor, GaLore-Adafactor (external refresh, Fig. 3's setting),
GaLore-SGD, LoRA and ReLoRA, and the launcher's ``--optimizer adafactor`` /
``sgd`` on the CPU."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import galore as jgal  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticC4 as JSyntheticC4  # noqa: E402
from repro.distributed.step import make_refresh_step as jax_make_refresh_step  # noqa: E402
from repro.distributed.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import lowrank as jlr  # noqa: E402
from repro.optim.adafactor import scale_by_adafactor as jax_scale_by_adafactor  # noqa: E402
from repro.optim.adam import scale_by_adam as jax_scale_by_adam  # noqa: E402
from repro.optim import transform as jtr  # noqa: E402
from repro.optim.transform import apply_updates as jax_apply_updates  # noqa: E402
from repro.optim.transform import trace as jax_trace  # noqa: E402
from repro.quant import QuantPolicy as JQuantPolicy  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    adaptors_from_numpy,
    galore_state_from_numpy,
    galore_state_to_numpy,
    params_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.galore import galore  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import lowrank  # noqa: E402
from repro_torch.optim.adafactor import adafactor_state_bytes, scale_by_adafactor  # noqa: E402
from repro_torch.optim.adam import scale_by_adam  # noqa: E402
from repro_torch.optim.factory import build_optimizer  # noqa: E402
from repro_torch.optim import transform as ttr  # noqa: E402
from repro_torch.optim.transform import apply_updates, trace  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402
from repro_torch.utils import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402
from test_torch_train import _Bridged  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

STEPS, BATCH, SEQ = 20, 4, 64


def _np(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(x, int):  # the port's host-int step: the reference's int32
        return np.asarray(x, np.int32)
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _flat(tree):
    return {k: _np(v) for k, v in tree_leaves_with_path(tree)}


def _jflat(tree):
    from repro.utils import path_str

    return {path_str(p): _np(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, name, tol=1e-6):
    """|got - want| ≤ tol·max|want| (f32 leaves: normwise relative)."""
    got, want = _np(got).astype(np.float32), _np(want).astype(np.float32)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def _bf16_ulp_close(got, want, name):
    """Every element of a bf16 output within one bf16 ulp of JAX's, or, where
    the f32 value before the cast nearly cancelled, within the f32 gate
    1e-6·max|want| (a bf16 ulp of a value 1e-5 of the leaf's largest is
    below the f32 rounding of the sum that made it)."""
    got, want = _np(got).astype(np.float32), _np(want).astype(np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    err = np.abs(got - want)
    ok = (err <= ulp) | (err <= 1e-6 * np.abs(want).max())
    assert np.all(ok), (name, want[~ok][:4], got[~ok][:4])


def _states_close(got, want, tol=1e-6):
    """Equal leaf paths, dtypes and shapes; f32 values within tol·max."""
    got, want = _flat(got), _jflat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        _close(got[k], want[k], k, tol)


# ---------------------------------------------------------------------------
# 1. Adafactor and trace, five steps
# ---------------------------------------------------------------------------

# a stacked 3-D leaf (vr (L, m), vc (L, n)), a stacked (L, d) leaf (factored
# across its layers: vr (L,), vc (d,)) and a 1-D leaf (full v)
LEAVES = {"stack": (2, 24, 40), "norm": (2, 40), "bias": (40,)}


def _five_steps(jopt, topt, dtype):
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    rng = np.random.default_rng(1)
    jstate = jopt.init({k: jnp.zeros(s, jd) for k, s in LEAVES.items()})
    state = topt.init({k: torch.zeros(s, dtype=td) for k, s in LEAVES.items()})
    for step in range(5):
        g = {k: (rng.standard_normal(s) * 10.0 ** (step - 2)).astype(np.float32)
             for k, s in LEAVES.items()}
        jupd, jstate = jopt.update({k: jnp.asarray(v).astype(jd) for k, v in g.items()}, jstate)
        upd, state = topt.update({k: torch.from_numpy(v).to(td) for k, v in g.items()}, state)
        for k in LEAVES:
            assert upd[k].dtype == td and jupd[k].dtype == jd, k
            if dtype == "float32":
                _close(upd[k], jupd[k], f"step {step} {k}")
            else:
                _bf16_ulp_close(upd[k], jupd[k], f"step {step} {k}")
    _states_close(state, jstate)
    return state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("beta1", [0.9, None])
def test_adafactor_matches_jax(beta1, dtype):
    """scale_by_adafactor against the reference's over five steps of growing
    gradients: updates within 1e-6·max (f32) or one bf16 ulp, the state's
    paths, shapes and dtypes equal and its values within 1e-6·max, and the
    state's bytes the analytic count."""
    state = _five_steps(jax_scale_by_adafactor(beta1=beta1), scale_by_adafactor(beta1=beta1),
                        dtype)
    assert state["v"]["norm"]["vr"].shape == (2,) and state["v"]["norm"]["vc"].shape == (40,)
    measured = sum(t.numel() * 4 for t in tree_leaves([state["v"], state.get("m", {})]))
    assert measured == adafactor_state_bytes(
        {k: torch.empty(s) for k, s in LEAVES.items()}, beta1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nesterov", [False, True])
def test_trace_matches_jax(nesterov, dtype):
    _five_steps(jax_trace(0.9, nesterov), trace(0.9, nesterov), dtype)


TRANSFORMS = {
    "identity": lambda t: t.identity(),
    "scale": lambda t: t.scale(-0.5),
    "decay": lambda t: t.add_decayed_weights(0.1),
    "decay_masked": lambda t: t.add_decayed_weights(0.1, mask=lambda path: "attn" in path),
}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_helpers_match_jax(name):
    """identity, scale and add_decayed_weights (with a mask on the dotted
    path: only the attention leaf decays), as the reference's; and
    tree_zeros_like_f32's zeros."""
    rng = np.random.default_rng(5)
    params = {"attn": {"wq": rng.standard_normal((4, 6)).astype(np.float32)},
              "norm": {"scale": rng.standard_normal((6,)).astype(np.float32)}}
    grads = {k: {n: 2.0 * a for n, a in v.items()} for k, v in params.items()}
    jt, tt = TRANSFORMS[name](jtr), TRANSFORMS[name](ttr)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), tree_map(torch.from_numpy, params)
    want, _ = jt.update(jax.tree_util.tree_map(jnp.asarray, grads), jt.init(jp), jp)
    got, _ = tt.update(tree_map(torch.from_numpy, grads), tt.init(tp), tp)
    got, want = _flat(got), _jflat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        _close(got[k], want[k], k)
    if name == "decay_masked":
        np.testing.assert_array_equal(got["norm.scale"], grads["norm"]["scale"])
    zeros = ttr.tree_zeros_like_f32(tp)
    assert all(z.dtype == torch.float32 and not z.any() for z in tree_leaves(zeros))


def test_adafactor_update_keeps_rms_clip_per_leaf():
    """The update-RMS clip runs over the whole stacked leaf: a leaf whose
    two layers differ 100× in scale is clipped as one (the small layer is
    not scaled up), as the reference does it."""
    g = torch.ones(2, 8, 8)
    g[1] *= 100.0
    opt = scale_by_adafactor(beta1=None)
    upd, _ = opt.update({"w": g}, opt.init({"w": g}))
    jupd, _ = jax_scale_by_adafactor(beta1=None).update(
        {"w": jnp.asarray(g.numpy())}, jax_scale_by_adafactor(beta1=None).init(
            {"w": jnp.zeros((2, 8, 8))}))
    _close(upd["w"], jupd["w"], "w")
    rms = float(upd["w"].square().mean().sqrt())
    assert rms <= 1.0 + 1e-6


# ---------------------------------------------------------------------------
# 2. GaLore over a non-Adam inner transform (the composable path)
# ---------------------------------------------------------------------------

# a left leaf (m ≤ n), a stacked right leaf, a passthrough 1-D leaf and an
# excluded embedding
GALORE_LEAVES = {"wl": (32, 64), "wr": (2, 48, 24), "scale": (24,), "embed": (40, 16)}


def _inner_pair(name):
    if name == "adafactor":
        return jax_scale_by_adafactor(beta1=0.9), scale_by_adafactor(beta1=0.9)
    return jax_trace(0.9), trace(0.9)


@pytest.mark.parametrize("proj", ["fp32", "int4"])
@pytest.mark.parametrize("inner", ["adafactor", "sgd"])
def test_galore_over_inner_matches_jax(inner, proj):
    """galore(inner=…) against JAX's composable path: the refresh step's
    update within 2e-5·max (an SVD's column signs cancel in P·inner(PᵀG)),
    the state's paths, shapes and dtypes equal; then, from JAX's state
    handed across, the next update and every state leaf within 2e-5."""
    rng = np.random.default_rng(3)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in GALORE_LEAVES.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in GALORE_LEAVES.items()}
             for _ in range(2)]
    kw = dict(rank=8, update_freq=5, scale=0.25)
    jcfg = JGaLoreConfig(**kw, quant=JQuantPolicy(projectors=proj))
    cfg = GaLoreConfig(**kw, quant=QuantPolicy(projectors=proj))
    jinner, tinner = _inner_pair(inner)
    jopt = jgal.galore(jinner, jcfg)
    opt = galore(cfg, inner=tinner)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = params_from_numpy(params, "cpu")
    jstate = jopt.init(jp)
    state = opt.init(tp)
    assert sorted(_flat(state)) == sorted(_jflat(jstate))
    for step, g in enumerate(grads):
        jupd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        upd, state = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, tp)
        for k in GALORE_LEAVES:
            assert upd[k].dtype == torch.float32, k
            _close(upd[k], jupd[k], f"step {step} {k}", 2e-5)
        got, want = _flat(state), _jflat(jstate)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if step == 0:  # from here on the same projectors: JAX's, handed across
            state = galore_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    _states_close({k: v for k, v in state.items() if k != "key"},
                  {k: v for k, v in jstate.items() if k != "key"}, 2e-5)
    back = _flat(galore_state_to_numpy(state))
    for k, want in _jflat(jstate).items():  # the bridge both ways
        assert back[k].dtype == want.dtype and back[k].shape == want.shape, k


# ---------------------------------------------------------------------------
# 3. the factory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("galore_on", [False, True])
@pytest.mark.parametrize("optname", ["adamw", "adam8bit", "adafactor", "sgd"])
def test_factory_builds_and_steps_with_galore(optname, galore_on):
    """Fig 3: GaLore composes with AdamW / 8-bit Adam / Adafactor / SGD; each
    builds and steps, with GaLore and without it (the reference's test), and
    the step lands within 2e-5 of the reference's chain on the same inputs."""
    g = dict(rank=8, update_freq=5)
    jtc = JTrainConfig(optimizer=optname, galore=JGaLoreConfig(**g) if galore_on else None,
                       lr=1e-3, total_steps=10, warmup_steps=2)
    tc = TrainConfig(optimizer=optname, galore=GaLoreConfig(**g) if galore_on else None,
                     lr=1e-3, total_steps=10, warmup_steps=2)
    from repro.optim.factory import build_optimizer as jax_build_optimizer

    jopt, opt = jax_build_optimizer(jtc), build_optimizer(tc)
    w = np.array(jax.random.normal(jax.random.PRNGKey(0), (32, 64)))
    jp = {"w": jnp.zeros((32, 64)), "b": jnp.zeros((64,))}
    tp = {"w": torch.zeros(32, 64), "b": torch.zeros(64)}
    jupd, _ = jopt.update({"w": jnp.asarray(w), "b": jnp.ones((64,))}, jopt.init(jp), jp)
    upd, _ = opt.update({"w": torch.from_numpy(w), "b": torch.ones(64)}, opt.init(tp), tp)
    params = apply_updates(tp, upd)
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))
    jparams = jax_apply_updates(jp, jupd)
    for k in ("w", "b"):
        _close(params[k], jparams[k], k, 2e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(optimizer="adafactor", galore_fused_adam=True), "Adam-shaped"),
    (dict(optimizer="sgd", galore_fused_adam=True), "Adam-shaped"),
    (dict(optimizer="adafactor", quant="int8"), "quantized moments"),
    (dict(optimizer="sgd", quant="int8"), "quantized moments"),
    (dict(optimizer="sgd", galore_fused_apply=True), "galore_fused_apply requires"),
    (dict(optimizer="lion"), "unknown optimizer"),
])
def test_factory_refuses_as_the_reference(kw, match):
    """The reference's ValueError refusals, kept: a fused step or quantized
    moments around a non-Adam inner, apply without fused, an unknown name;
    no NotImplementedError is left."""
    kw = dict(kw)
    quant = QuantPolicy(moments=kw.pop("quant")) if "quant" in kw else QuantPolicy()
    tc = TrainConfig(galore=GaLoreConfig(rank=8, update_freq=5, quant=quant), **kw)
    with pytest.raises(ValueError, match=match):
        build_optimizer(tc)


# ---------------------------------------------------------------------------
# 4. LoRA / ReLoRA / low-rank
# ---------------------------------------------------------------------------


def _smoke_params():
    jcfg = jax_get_config("llama_60m", smoke=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def test_init_adaptors_leaves_and_counts_match_jax():
    """The same leaves adapted (attention and FFN; not the embedding, the
    norms), the same shapes, A ~ N(0, 1/r) and B = 0, and the same
    adaptor_param_count as the reference's."""
    jparams, tparams = _smoke_params()
    jad = jlr.init_adaptors(jparams, jlr.LoraConfig(rank=16), jax.random.PRNGKey(0))
    ad = lowrank.init_adaptors(tparams, lowrank.LoraConfig(rank=16),
                               torch.Generator().manual_seed(0))
    got, want = _flat(ad), _jflat(jad)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k.endswith(".B"):
            assert not got[k].any(), k
    assert {k.rsplit(".", 1)[0] for k in got if k.endswith(".A")} == {
        f"blocks.{m}" for m in ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "ffn.gate",
                                "ffn.up", "ffn.down")}
    A = got["blocks.ffn.up.A"]
    assert abs(A.std() * 4.0 - 1.0) < 0.05  # r^-0.5 = 1/4
    assert lowrank.adaptor_param_count(ad) == jlr.adaptor_param_count(jad)


def _random_adaptors(jparams, rank, seed):
    """The reference's adaptors with B drawn too (so BA ≠ 0)."""
    jad = jlr.init_adaptors(jparams, jlr.LoraConfig(rank=rank), jax.random.PRNGKey(seed))
    return _with_b(jad, np.random.default_rng(seed))


def _with_b(jad, rng):
    if isinstance(jad, dict) and set(jad) == {"A", "B"}:
        B = rng.standard_normal(jad["B"].shape).astype(np.float32) * 0.1
        return {"A": jad["A"], "B": jnp.asarray(B)}
    if isinstance(jad, dict):
        return {k: _with_b(v, rng) for k, v in jad.items()}
    return jad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["lora", "lowrank"])
def test_merge_matches_jax(mode, dtype):
    """merge with the reference's A and a random B, handed across: the
    effective weights in W's dtype, within 1e-6·max of JAX's (f32) or one
    bf16 ulp (bf16 W: W0 + sBA summed in f32, then cast); unadapted leaves
    untouched."""
    jparams, _ = _smoke_params()
    if dtype == "bfloat16":
        jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jparams)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    cfg, jcfg = lowrank.LoraConfig(rank=16, mode=mode), jlr.LoraConfig(rank=16, mode=mode)
    jad = _random_adaptors(jparams, 16, 2)
    ad = adaptors_from_numpy(jax.tree_util.tree_map(np.asarray, jad), "cpu")
    got, want = _flat(lowrank.merge(tparams, ad, cfg)), _jflat(jlr.merge(jparams, jad, jcfg))
    for k in want:
        if dtype == "float32":
            _close(got[k], want[k], k)
        else:
            _bf16_ulp_close(got[k], want[k], k)
    assert np.array_equal(got["embed.embedding"], _np(tparams["embed"]["embedding"]))


def test_merge_grads_reach_only_adaptors():
    _, tparams = _smoke_params()
    cfg = lowrank.LoraConfig(rank=16)
    ad = lowrank.init_adaptors(tparams, cfg, torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, 512, (2, 16), generator=torch.Generator().manual_seed(1))}
    loss, _ = TM.loss_fn(get_config("llama_60m", smoke=True), lowrank.merge(tparams, ad, cfg),
                         batch)
    grads = lowrank.adaptor_grads(loss, ad)
    assert float(grads["blocks"]["attn"]["wq"]["B"].abs().max()) > 0  # B = 0, A ≠ 0
    assert float(grads["blocks"]["attn"]["wq"]["A"].abs().max()) == 0.0
    assert grads["embed"]["embedding"].shape == ()
    assert all(p.grad is None for p in tree_leaves(tparams))


def test_relora_merge_matches_jax():
    """relora_merge folds s·BA into W0 (within 1e-6·max of JAX's fold) and
    re-initialises the adaptors: B′ = 0, A′ of A's shapes, drawn anew; the
    merged weights just before and just after the merge are equal."""
    jparams, tparams = _smoke_params()
    cfg, jcfg = (lowrank.LoraConfig(rank=16, mode="relora"),
                 jlr.LoraConfig(rank=16, mode="relora"))
    jad = _random_adaptors(jparams, 16, 4)
    ad = adaptors_from_numpy(jax.tree_util.tree_map(np.asarray, jad), "cpu")
    jnew, jnew_ad = jlr.relora_merge(jparams, jad, jcfg, jax.random.PRNGKey(9))
    before = lowrank.merge(tparams, ad, cfg)
    new, new_ad = lowrank.relora_merge(tparams, ad, cfg, torch.Generator().manual_seed(9))
    for k, want in _jflat(jnew).items():
        _close(_flat(new)[k], want, k)
    after = lowrank.merge(new, new_ad, cfg)
    for (k, b), a in zip(tree_leaves_with_path(before), tree_leaves(after)):
        assert torch.equal(a, b), k
    got, want = _flat(new_ad), _jflat(jnew_ad)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k.endswith(".B"):
            assert not got[k].any(), k
        elif k.endswith(".A"):
            assert not np.array_equal(got[k], _flat(ad)[k]), k
    assert all(t.requires_grad for t in tree_leaves(new_ad) if t.ndim >= 2)


# ---------------------------------------------------------------------------
# 5. 20-step trajectories against the JAX package
# ---------------------------------------------------------------------------

_G16 = dict(rank=16, update_freq=10)
TRAJECTORIES = {
    "adafactor": dict(optimizer="adafactor"),
    # Fig. 3's setting (benchmarks/fig3_optimizers.py): r 16, T 40, α 0.25,
    # lr 5e-3, warmup steps // 10, the external refresh
    "galore-adafactor": dict(optimizer="adafactor", lr=5e-3,
                             galore=dict(rank=16, update_freq=40, scale=0.25),
                             galore_external_refresh=True),
    "galore-sgd": dict(optimizer="sgd", galore=_G16),
    "lora": dict(lora=dict(rank=16, alpha=32, mode="lora")),
    "relora": dict(lora=dict(rank=16, alpha=32, mode="relora", merge_freq=10)),
}
LORA_LR = 5e-3  # benchmarks/table2_methods.py::_train_lowrank's default


def _jax_lowrank(jcfg, lcfg, jparams, data, steps, lr):
    """benchmarks/table2_methods.py::_train_lowrank on given params and
    data; returns (losses, {merge step: the re-initialised adaptors})."""
    key = jax.random.PRNGKey(0)
    base = jparams
    adaptors = jlr.init_adaptors(base, lcfg, key)
    opt = jax_scale_by_adam()
    st = opt.init(adaptors)

    @jax.jit
    def step_fn(base, adaptors, st, batch):
        def loss_fn(ad):
            return JM.loss_fn(jcfg, jlr.merge(base, ad, lcfg), batch)[0]

        loss, g = jax.value_and_grad(loss_fn)(adaptors)
        upd, st2 = opt.update(g, st, adaptors)
        ad2 = jax_apply_updates(adaptors, jax.tree_util.tree_map(lambda u: -lr * u, upd))
        return ad2, st2, loss

    losses, resets = [], {0: adaptors}
    for i in range(steps):
        if lcfg.merge_freq and i > 0 and i % lcfg.merge_freq == 0:
            base, adaptors = jlr.relora_merge(base, adaptors, lcfg, jax.random.fold_in(key, i))
            resets[i] = adaptors
            st = opt.init(adaptors)  # ReLoRA optimizer reset
        adaptors, st, loss = step_fn(base, adaptors, st, data.batch(i))
        losses.append(float(loss))
    return losses, resets


def _port_lowrank(cfg, lcfg, params, data, steps, lr, adaptors_at):
    """The same loop in the port: Adam on the adaptors, a constant −lr, at a
    ReLoRA merge relora_merge and a fresh Adam state. `adaptors_at(step)`
    gives the adaptors (the reference's A, handed across) at step 0 and at
    each merge."""
    base, adaptors = params, adaptors_at(0)
    opt = scale_by_adam()
    st = opt.init(adaptors)
    losses = []
    for i in range(steps):
        if lcfg.merge_freq and i > 0 and i % lcfg.merge_freq == 0:
            base, _ = lowrank.relora_merge(base, adaptors, lcfg, torch.Generator())
            adaptors = adaptors_at(i)
            st = opt.init(adaptors)
        loss, _ = TM.loss_fn(cfg, lowrank.merge(base, adaptors, lcfg), data.batch(i))
        grads = lowrank.adaptor_grads(loss, adaptors)
        with torch.no_grad():
            upd, st = opt.update(grads, st, adaptors)
            apply_updates(adaptors, tree_map(lambda u: -lr * u, upd))
        losses.append(float(loss.detach()))
    return losses


def _configs(case):
    kw = dict(TRAJECTORIES[case])
    g = kw.pop("galore", None)
    common = dict(total_steps=STEPS, warmup_steps=STEPS // 10, **kw)
    return (JTrainConfig(galore=JGaLoreConfig(**g) if g else None, **common),
            TrainConfig(galore=GaLoreConfig(**g) if g else None, **common))


@pytest.fixture(scope="module")
def jax_trajectory():
    """Per case, once: the JAX package's 20 losses from its initial weights
    and batches (and the adaptors it re-initialises at each ReLoRA merge)."""
    jcfg = jax_get_config("llama_60m", smoke=True)
    jdata = JSyntheticC4(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                     batch_per_host=BATCH))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    cache = {}

    def run(case):
        if case in cache:
            return cache[case]
        spec = TRAJECTORIES[case]
        if "lora" in spec:
            lcfg = jlr.LoraConfig(**spec["lora"])
            losses, resets = _jax_lowrank(jcfg, lcfg, jparams, jdata, STEPS, LORA_LR)
        else:
            jtc, _ = _configs(case)
            step_fn, jopt = jax_make_train_step(jcfg, jtc)
            step_fn = jax.jit(step_fn)
            refresh = (jax.jit(jax_make_refresh_step(jcfg, jtc))
                       if jtc.galore_external_refresh else None)
            p, st, losses, resets = jparams, jopt.init(jparams), [], None
            for s in range(STEPS):
                b = jdata.batch(s)
                if refresh is not None and s % jtc.galore.update_freq == 0:
                    st = refresh(p, st, b)
                p, st, m = step_fn(p, st, b)
                losses.append(float(m["loss"]))
        cache[case] = dict(losses=losses, resets=resets, jdata=jdata,
                           params=jax.tree_util.tree_map(np.asarray, jparams))
        return cache[case]

    return run


@pytest.mark.parametrize("case", list(TRAJECTORIES))
def test_baseline_trajectory_matches_jax(jax_trajectory, case, tmp_path):
    """20 steps at llama_60m smoke from the JAX package's weights and batches:
    every loss within 5e-2 of the JAX run's (its make_train_step for the
    optimizers, a JAX loop written as table2_methods._train_lowrank for the
    adaptors), and training lowers the loss."""
    want = jax_trajectory(case)
    cfg = get_config("llama_60m", smoke=True)
    params = params_from_numpy(want["params"], "cpu")
    data = _Bridged(want["jdata"])
    spec = TRAJECTORIES[case]
    if "lora" in spec:
        lcfg = lowrank.LoraConfig(**spec["lora"])
        at = lambda s: adaptors_from_numpy(  # noqa: E731
            jax.tree_util.tree_map(np.asarray, want["resets"][s]), "cpu")
        got = _port_lowrank(cfg, lcfg, params, data, STEPS, LORA_LR, at)
    else:
        _, tc = _configs(case)
        got = []
        train_loop(RunConfig(steps=STEPS, batch_per_host=BATCH, seq_len=SEQ, log_every=STEPS,
                             ckpt_dir=str(tmp_path), ckpt_every=0, device="cpu"),
                   tc, cfg=cfg, params=params, data=data,
                   on_step=lambda s, m: got.append(float(m["loss"])))
    np.testing.assert_allclose(got, want["losses"], rtol=0, atol=5e-2)
    assert want["losses"][-1] < want["losses"][0]


# ---------------------------------------------------------------------------
# 6. the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args,rc", [
    (["--optimizer", "adafactor", "--galore-rank", "16", "--galore-t", "2"], 0),
    (["--optimizer", "adafactor"], 0),
    (["--optimizer", "sgd"], 0),
    (["--optimizer", "sgd", "--galore-rank", "16", "--galore-fused"], 2),
], ids=["galore-adafactor", "adafactor", "sgd", "sgd-fused-refused"])
def test_cli_trains_baselines_on_cpu(tmp_path, capsys, args, rc):
    """A few steps of each baseline optimizer through the launcher's main on
    the CPU, finite losses (GaLore-Adafactor refreshing at steps 0 and 2); a
    fused step around SGD exits 2. In process: a subprocess would spend its
    time importing torch."""
    from repro_torch.launch import train as launcher

    argv = ["--steps", "3", "--seq", "32", "--batch", "2", "--log-every", "1",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"] + args
    if rc:
        with pytest.raises(SystemExit) as exit_info:
            launcher.main(argv)
        assert exit_info.value.code == rc
        assert "needs Adam moments" in capsys.readouterr().err
        return
    launcher.main(argv)
    losses = [float(line.split()[4]) for line in capsys.readouterr().out.splitlines()
              if line.startswith("[train] step")]
    assert len(losses) == 3 and all(np.isfinite(losses))


@pytest.mark.parametrize("optimizer", ["adafactor", "sgd"])
@pytest.mark.parametrize("path", ["async", "guard", "resume"])
def test_launcher_paths_run_with_baseline_inners(tmp_path, optimizer, path):
    """GaLore over Adafactor or SGD through the launcher's other paths, 6
    smoke steps: the async double-buffered refresh (its swap touches the
    projectors only); the anomaly guard with NaN gradients at steps 2-3
    (each skip a no-op, then clean steps); and a resume from a step-2
    checkpoint that lands on the straight run's losses and state bit for
    bit."""
    cfg = get_config("llama_60m", smoke=True)
    tc = TrainConfig(optimizer=optimizer, galore=GaLoreConfig(rank=8, update_freq=2),
                     galore_refresh_async=path == "async", anomaly_guard=path == "guard",
                     total_steps=6, warmup_steps=1)

    def run(ckpt_dir, steps, ckpt_every=0, faults=None):
        losses = {}
        out = train_loop(RunConfig(steps=steps, batch_per_host=2, seq_len=16, log_every=100,
                                   ckpt_dir=str(ckpt_dir), ckpt_every=ckpt_every, device="cpu"),
                         tc, cfg=cfg, faults=faults,
                         on_step=lambda s, m: losses.__setitem__(s, float(m["loss"])))
        return losses, out

    if path == "resume":
        straight, (p1, s1, _, _) = run(tmp_path / "straight", 6)
        run(tmp_path / "split", 3, ckpt_every=2)
        resumed, (p2, s2, _, _) = run(tmp_path / "split", 6, ckpt_every=2)
        assert sorted(resumed) == [3, 4, 5]
        assert resumed == {k: straight[k] for k in resumed}
        a, b = _flat({"p": p2, "s": s2}), _flat({"p": p1, "s": s1})
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        return
    losses, (params, state, metrics, _) = run(
        tmp_path, 6, faults=["nan_grad@2*2"] if path == "guard" else None)
    assert sorted(losses) == list(range(6)) and all(np.isfinite(list(losses.values())))
    if path == "guard":
        assert int(metrics["guard_skips"]) == 2
    assert state[1]["step"] == (4 if path == "guard" else 6)
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))


def test_state_bridge_round_trips_adafactor_and_trace():
    """Adafactor's and trace's JAX states cross to the port and back leaf for
    leaf, dtypes kept (f32 statistics, int32 count)."""
    params = {k: jnp.zeros(s) for k, s in LEAVES.items()}
    g = {k: jnp.ones(s) for k, s in LEAVES.items()}
    for jopt in (jax_scale_by_adafactor(), jax_trace(0.9)):
        _, jstate = jopt.update(g, jopt.init(params))
        jnp_state = jax.tree_util.tree_map(np.asarray, jstate)
        back = _flat(state_to_numpy(state_from_numpy(jnp_state, "cpu")))
        want = _jflat(jnp_state)
        assert sorted(back) == sorted(want)
        for k in want:
            assert back[k].dtype == want[k].dtype
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)
