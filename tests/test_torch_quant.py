"""The port's 8-bit GaLore state against the JAX package on the same
inputs: the codecs bit for bit, projector storage and its lazy refresh, the
int8-moment leaf step against the Pallas epilogue in interpret mode, and the
fp32-moment step with a packed int4 projector, as a leaf step against the
Pallas epilogue and as a 20-step trajectory.
(The rest of the training path is in tests/test_torch_quant_train.py.)"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.projector import read_projector as jax_read_projector  # noqa: E402
from repro.core.projector import store_projector as jax_store_projector  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticC4 as JSyntheticC4  # noqa: E402
from repro.distributed.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.quant import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.quant import codec as jcodec  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.galore import galore  # noqa: E402
from repro_torch.core.projector import read_projector, store_projector  # noqa: E402
from repro_torch.kernels import galore_fused as tk  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.quant import QuantPolicy, codec  # noqa: E402
from repro_torch.utils import flatten_up_to  # noqa: E402
from test_torch_cuda import (  # noqa: E402
    ADAM8_CASES,
    adam8_inputs,
    assert_codes_close,
    fused_inputs,
)
from test_torch_train import _Bridged  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

HP = dict(b1=0.9, b2=0.999, eps=1e-8)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _assert_bitwise(got, want, name):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (name, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=name)


def _assert_close(got, want, name, tol=1e-5):
    """|got - want| ≤ tol·max|want| + tol·|want|."""
    want = _np(want).astype(np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * np.abs(want).max(),
                               err_msg=name)


# ---------------------------------------------------------------------------
# 1. codecs, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("signed", [True, False])
def test_codebooks_match(signed):
    _assert_bitwise(codec.dynamic_codebook(signed), jcodec.dynamic_codebook(signed), "book")
    _assert_bitwise(codec.int4_codebook(), jcodec.int4_codebook(), "book4")


@pytest.mark.parametrize("axis,shape", [(-1, (7, 130)), (-1, (3, 5, 520)),
                                        (-2, (130, 7)), (-2, (2, 520, 9))])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("stochastic", [False, True])
def test_axis_codec_matches(axis, shape, signed, stochastic):
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    x = (rng.standard_normal(shape) * 3.0).astype(np.float32)
    if not signed:
        x = np.abs(x)
    kw = dict(axis=axis, signed=signed, stochastic=stochastic, salt=codec.SR_SALT_V)
    jq, js = jax.jit(lambda a, c: jcodec.quantize_axis(a, count=c, **kw))(jnp.asarray(x),
                                                                          jnp.int32(9))
    tq, ts = codec.quantize_axis(torch.from_numpy(x), count=torch.tensor(9, dtype=torch.int32),
                                 **kw)
    _assert_bitwise(tq, jq, "codes")
    _assert_bitwise(ts, js, "scales")
    _assert_bitwise(codec.dequantize_axis(tq, ts, axis=axis, signed=signed),
                    jax.jit(lambda q, s: jcodec.dequantize_axis(q, s, axis=axis, signed=signed))(
                        jq, js), "dequant")


@pytest.mark.parametrize("kept", [64, 72, 1000])
def test_int4_axis_codec_matches(kept):
    x = (np.random.default_rng(kept).standard_normal((2, kept, 24)) / 9).astype(np.float32)
    jq, js = jax.jit(jcodec.quantize4_axis)(jnp.asarray(x))
    tq, ts = codec.quantize4_axis(torch.from_numpy(x))
    _assert_bitwise(tq, jq, "packed")
    _assert_bitwise(ts, js, "scales")
    _assert_bitwise(codec.dequantize4_axis(tq, ts, kept),
                    jax.jit(jcodec.dequantize4_axis, static_argnums=2)(jq, js, kept), "dequant")


def test_sr_uniform_matches_above_2_31():
    idx = np.array([0, 1, 12345, 2**31 - 1, 2**31, 2**31 + 7, 3 * 2**30, 2**32 - 2, 2**32 - 1],
                   np.uint32)
    for count, salt in ((1, codec.SR_SALT_M), (2**31 + 3, codec.SR_SALT_V)):
        want = jcodec.sr_uniform(jnp.asarray(idx), jnp.uint32(count), salt)
        got = codec.sr_uniform(torch.from_numpy(idx.astype(np.int64)), count, salt)
        _assert_bitwise(got, want, f"count {count}")


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n", [2, 4])
def test_axis_codec_block_with_origin_is_the_full_leafs_slice(side, n):
    """A rank block of a GaLore leaf's moments (left (L, r, n) split on r,
    blocks along n; right (L, m, r) split on r, blocks along m), quantized
    stochastically with its origin in the full leaf, gives exactly the slice
    of the JAX codec's full-leaf codes and scales (its coins keyed on the
    global ravel index); without the origin (the old rule) the codes
    differ; nearest rounding ignores the origin."""
    lead, r, sw = (3,), 16, 260
    shape, axis, dim = ((lead + (r, sw)), -1, -2) if side == "left" else (lead + (sw, r), -2, -1)
    x = (np.random.default_rng(n).standard_normal(shape) * 3.0).astype(np.float32)
    count = torch.tensor(11, dtype=torch.int32)
    for signed, salt in ((True, codec.SR_SALT_M), (False, codec.SR_SALT_V)):
        xs = x if signed else np.abs(x)
        kw = dict(axis=axis, signed=signed, salt=salt)
        jq, js = jax.jit(lambda a: jcodec.quantize_axis(a, count=jnp.int32(11), stochastic=True,
                                                        **kw))(jnp.asarray(xs))
        rb, differs = r // n, 0
        for k in range(n):
            blk = torch.from_numpy(xs).narrow(dim, k * rb, rb).contiguous()
            tq, ts = codec.quantize_axis(blk, count=count, stochastic=True,
                                         origin=(dim, k * rb, r), **kw)
            want_q = np.take(np.asarray(jq), range(k * rb, (k + 1) * rb), axis=dim)
            want_s = np.take(np.asarray(js), range(k * rb, (k + 1) * rb), axis=dim)
            _assert_bitwise(tq, want_q, f"{side} block {k} of {n} codes")
            _assert_bitwise(ts, want_s, f"{side} block {k} of {n} scales")
            local, _ = codec.quantize_axis(blk, count=count, stochastic=True, **kw)
            differs += int((local.numpy() != want_q).sum())
            near = [codec.quantize_axis(blk, count=count, origin=o, **kw)[0]
                    for o in (None, (dim, k * rb, r))]
            assert torch.equal(*near)
        assert differs > 0, "the block-local coins would have passed: the check is blind"


# ---------------------------------------------------------------------------
# 2. projector storage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int4"])
def test_projector_store_read_matches(mode):
    P = (np.random.default_rng(2).standard_normal((2, 72, 16)) / 7).astype(np.float32)
    want = jax_store_projector(jnp.asarray(P), mode)
    got = store_projector(torch.from_numpy(P), mode)
    if mode == "int4":
        _assert_bitwise(got["q"], want["q"], "codes")
        _assert_bitwise(got["scale"], want["scale"], "scales")
    else:
        _assert_bitwise(got.float(), np.asarray(want).astype(np.float32), mode)
    _assert_bitwise(read_projector(got, P.shape), jax_read_projector(want, P.shape), "read")


def test_int4_projector_refresh_and_lazy_skip():
    """int4 storage survives refreshes; lazy_refresh keeps the stored state
    (codes and scales) when a refresh would leave the codes unchanged."""
    rng = np.random.default_rng(9)
    U = np.linalg.qr(rng.standard_normal((48, 4)))[0].astype(np.float32)
    C = rng.standard_normal((4, 96)).astype(np.float32)
    Cp = C + np.float32(1e-4) * rng.standard_normal((4, 96)).astype(np.float32)
    params = {"w": torch.zeros(48, 96)}
    qp = QuantPolicy(projectors="int4", lazy_refresh=True, min_quant_size=1)
    cfg = GaLoreConfig(rank=4, update_freq=1, scale=1.0, quant=qp)

    def run(cfg, Cs):
        opt = galore(cfg, **HP)
        st = opt.init(params)
        assert codec.is_qstate(st["proj"]["w"])
        out = []
        for c in Cs:
            u, st = opt.update({"w": torch.from_numpy(U @ c)}, st, params)
            out.append({k: v.clone() for k, v in st["proj"]["w"].items()})
        return out, u

    (first, second), u = run(cfg, [C, Cp])
    assert first["q"].any()  # a real projector landed in int4 storage
    assert torch.equal(second["q"], first["q"]) and torch.equal(second["scale"], first["scale"])
    assert torch.isfinite(u["w"]).all()
    (first_nl, second_nl), _ = run(dataclasses.replace(
        cfg, quant=dataclasses.replace(qp, lazy_refresh=False)), [C, Cp])
    assert torch.equal(first_nl["q"], first["q"])
    assert not torch.equal(second_nl["scale"], first["scale"])  # a fresh quantization


# ---------------------------------------------------------------------------
# 3. the int8 leaf step against the Pallas epilogue (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,side", ADAM8_CASES)
@pytest.mark.parametrize("p_int4", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
def test_adam8_plain_matches_pallas_interpret(shape, side, p_int4, stochastic):
    P, G, moments = adam8_inputs(shape, side)
    right = side == "right"
    if p_int4:
        jP = jcodec.quant4_axis_state(jnp.asarray(P))
        tP = {k: torch.from_numpy(np.array(v)) for k, v in jP.items()}
    else:
        jP, tP = jnp.asarray(P), torch.from_numpy(P)
    jfn = jops.galore_fused_adam8_step_right if right else jops.galore_fused_adam8_step
    want = jfn(jP, jnp.asarray(G), *map(jnp.asarray, moments), jnp.int32(7), alpha=0.25,
               stochastic=stochastic, use_pallas=True, interpret=True)
    tfn = tk.galore_fused_adam8_step_right if right else tk.galore_fused_adam8_step
    mine = [torch.from_numpy(t.copy()) for t in moments]
    got = tfn(tP, torch.from_numpy(G), *mine, torch.tensor(7, dtype=torch.int32), alpha=0.25,
              stochastic=stochastic)
    assert all(a is b for a, b in zip(got[1:], mine))  # codes and scales updated in place
    tag = f"{side} {shape} int4 P {p_int4} stochastic {stochastic}"
    for name, a, b in zip(["update", "mq", "ms", "vq", "vs"], got, want):
        if a.dtype == torch.uint8:
            assert_codes_close(a, b, f"{tag} {name}")
        else:
            _assert_close(a, b, f"{tag} {name}")


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("apply", [False, True])
def test_adam8_rank_blocks_with_origin_give_the_full_leafs_codes(side, apply):
    """The int8 leaf step (the wrapper's CPU route, emit and apply) on each
    of two rank blocks of P and the moments, with the block's origin and
    stochastic rounding, writes exactly the slice of the whole leaf's codes
    and scales; the blocks' G̃ sum to the whole leaf's within 1e-5·max."""
    shape = (72, 16, 130) if side == "left" else (130, 16, 72)
    P, G, moments = adam8_inputs(shape, side)
    right, dim, r = side == "right", -1 if side == "right" else -2, shape[1]
    count = torch.tensor(7, dtype=torch.int32)
    hp = dict(alpha=0.25, stochastic=True)
    W = torch.from_numpy(np.random.default_rng(5).standard_normal(G.shape, np.float32))
    eta = torch.tensor(-1e-2)

    def step(Pb, mom, origin=None):
        mom = [torch.from_numpy(np.array(t)) for t in mom]  # copies: updated in place
        if apply:
            fn = tk.galore_fused_adam8_apply_step_right if right else tk.galore_fused_adam8_apply_step
            out = fn(torch.from_numpy(np.ascontiguousarray(Pb)), torch.from_numpy(G), W.clone(),
                     *mom, count, eta=eta, origin=origin, **hp)
            return out[0] - W, out[1:]
        fn = tk.galore_fused_adam8_step_right if right else tk.galore_fused_adam8_step
        out = fn(torch.from_numpy(np.ascontiguousarray(Pb)), torch.from_numpy(G), *mom, count,
                 origin=origin, **hp)
        return out[0], out[1:]

    full_upd, full = step(P, moments)
    rb, upd = r // 2, torch.zeros_like(full_upd)
    for k in range(2):
        cut = lambda t, d=dim: np.take(t, range(k * rb, (k + 1) * rb), axis=d)  # noqa: E731
        got_upd, got = step(cut(P, -1), [cut(t) for t in moments], origin=(k * rb, r))
        upd += got_upd
        for name, a, b in zip(("mq", "ms", "vq", "vs"), got, full):
            _assert_bitwise(a, cut(b.numpy()), f"{side} apply {apply} block {k} {name}")
    if not apply:  # the world sums the owners' partial G̃
        _assert_close(upd, full_upd, f"{side} G̃")


def test_adam8_cpu_wrapper_does_not_count_launches():
    tk.reset_launch_counts()
    P, G, moments = adam8_inputs(*ADAM8_CASES[0])
    tk.galore_fused_adam8_step(torch.from_numpy(P), torch.from_numpy(G),
                               *[torch.from_numpy(t.copy()) for t in moments],
                               torch.tensor(1, dtype=torch.int32))
    assert all(fn.launches == 0 for fn in tk.WRAPPERS)


# ---------------------------------------------------------------------------
# 4. the fp32-moment step with a packed int4 P
# ---------------------------------------------------------------------------

# (shape, side): ragged kept dims (72 → 128, 130 → 256), a stacked leaf
INT4P_CASES = [((72, 16, 130), "left"), ((130, 16, 72), "right"), ((3, 72, 16, 130), "left")]


@pytest.mark.parametrize("shape,side", INT4P_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4p_step_matches_pallas_interpret(shape, side, dtype):
    """galore_fused_adam_step[_right] with P as the packed int4 qstate (the
    plain version on the host-dequantized P) against the Pallas epilogue
    with quant_p, fp32 moments, in interpret mode: G̃, M' and V' within
    2e-5·max."""
    P, G, M, V = fused_inputs(shape, side)
    jP = jcodec.quant4_axis_state(jnp.asarray(P))
    tP = {k: torch.from_numpy(np.array(v)) for k, v in jP.items()}
    right = side == "right"
    jfn = jops.galore_fused_adam_step_right if right else jops.galore_fused_adam_step
    want = jfn(jP, jnp.asarray(G).astype(dtype), jnp.asarray(M), jnp.asarray(V), jnp.int32(7),
               alpha=0.25, use_pallas=True, interpret=True)
    tfn = tk.galore_fused_adam_step_right if right else tk.galore_fused_adam_step
    Mt, Vt = torch.from_numpy(M.copy()), torch.from_numpy(V.copy())
    tk.reset_launch_counts()
    got = tfn(tP, torch.from_numpy(G).to(getattr(torch, dtype)), Mt, Vt,
              torch.tensor(7, dtype=torch.int32), alpha=0.25)
    assert got[1] is Mt and got[2] is Vt  # moments updated in place
    assert tfn.launches == tfn.launches_int4 == 0  # the plain version ran
    for name, a, b in zip(["update", "m", "v"], got, want):
        _assert_close(a, b, f"{side} {shape} {dtype} {name}", tol=2e-5)


def test_int4p_trajectory_matches_jax(tmp_path):
    """20 steps of fused GaLore with fp32 moments and int4 projectors
    (--galore-fused --quant-proj int4; rank 16, T 10) on the llama_60m smoke
    config from the JAX package's weights and batches: per-step losses within
    5e-2 of JAX's run."""
    steps, batch, seq = 20, 4, 64
    jcfg = jax_get_config("llama_60m", smoke=True)
    jtc = JTrainConfig(optimizer="adamw", galore=JGaLoreConfig(
        rank=16, update_freq=10, quant=JQuantPolicy(projectors="int4")),
        galore_fused_adam=True, total_steps=steps, warmup_steps=2)
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
        rank=16, update_freq=10, quant=QuantPolicy(projectors="int4")),
        galore_fused_adam=True, total_steps=steps, warmup_steps=2)
    _, opt_state, _, _ = train_loop(
        RunConfig(steps=steps, batch_per_host=batch, seq_len=seq, log_every=steps,
                  ckpt_dir=str(tmp_path), device="cpu"),
        tc, cfg=get_config("llama_60m", smoke=True), params=tparams, data=_Bridged(jdata),
        on_step=lambda s, m: got.append(float(m["loss"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
    assert want[-1] < want[0]
    state = opt_state[1]
    assert any(codec.is_axis4_qstate(P) for P in flatten_up_to(tparams, state["proj"]))
    assert not any(codec.is_qstate(m) for m in flatten_up_to(tparams, state["inner"]["m"]))
