"""Routing of the port's GaLore step forms, the refusal of ``remat``, and a
CPU model of the split-TF32 arithmetic of the tiled projections.

1. The six int8-moment and weight-apply dispatchers of kernels/ops.py take
   the reference's route on both sides of ``fits_vmem`` (route spies), and
   at a shape that fails it each matches JAX's ``ops.*`` with
   ``use_pallas=True, interpret=True``, which runs the reference's plain
   fallback there.
2. ``check_ported`` refuses activation checkpointing.
3. Split TF32 emulated on the CPU: rounding to TF32 by bit operations, as
   ``cvt.rna.tf32.f32`` does, and the kernels' three-pass (two with a bf16 G)
   product against float64, within the kernels' gate.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import galore_fused as jgf  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.quant import codec as jcodec  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import galore_fused as tk  # noqa: E402
from repro_torch.kernels import galore_project as tp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from test_torch_cuda import (  # noqa: E402
    adam8_inputs,
    assert_codes_close,
    assert_weight_close,
    SPLIT_CASES,
    fused_inputs,
    split_tf32_inputs,
    split_tf32_matmul,
    tf32_rna,
    within_gate,
)
from test_torch_quant import _assert_close  # noqa: E402

ALPHA, COUNT, WD = 0.25, 7, 0.01
ETA = np.float32(-1e-2)
# (lead, m, r, n) of each side: one that fits the reference's VMEM budget,
# and one whose P (2, 2048, 1024) does not
FITS = {"left": (64, 16, 48), "right": (48, 16, 64)}
FAILS = {"left": (2, 2048, 1024, 96), "right": (2, 96, 1024, 2048)}
FORMS = ["adam8", "apply", "adam8_apply"]


def _name(form, side):
    base = {"adam8": "galore_fused_adam8_step", "apply": "galore_fused_adam_apply_step",
            "adam8_apply": "galore_fused_adam8_apply_step"}[form]
    return base + ("_right" if side == "right" else "")


def _p_args(P, p_int4):
    """P as JAX and the port take it: f32, or the JAX codec's packed int4
    qstate (the port's codec agrees with it bit for bit)."""
    if not p_int4:
        return jnp.asarray(P), torch.from_numpy(P)
    jP = jcodec.quant4_axis_state(jnp.asarray(P))
    return jP, {k: torch.from_numpy(np.array(v)) for k, v in jP.items()}


def _weight(shape, seed):
    lead, (m, _, n) = tuple(shape[:-3]), shape[-3:]
    return (np.random.default_rng(seed).standard_normal(lead + (m, n)) * 0.02).astype(np.float32)


def _leaf_args(form, shape, side, p_int4, w_dtype=torch.float32):
    """(jax args, torch args, torch W or None) of one leaf step: P, G, (W,)
    moments, count — moments from six earlier steps (int8 codes and scales
    for the adam8 forms)."""
    if form.startswith("adam8"):
        P, G, moments = adam8_inputs(shape, side)
    else:
        P, G, M, V = fused_inputs(shape, side)
        moments = (M, V)
    jP, tP = _p_args(P, p_int4)
    g_dt = jnp.bfloat16 if w_dtype == torch.bfloat16 else jnp.float32
    jargs, targs, W = [jP, jnp.asarray(G).astype(g_dt)], [tP, torch.from_numpy(G).to(w_dtype)], None
    if form.endswith("apply"):
        W = torch.from_numpy(_weight(shape, 4)).to(w_dtype)
        # a copy: JAX may alias a host buffer, and the port updates W in place
        jargs.append(jnp.asarray(W.float().numpy().copy()).astype(g_dt))
        targs.append(W)
    jargs += [jnp.asarray(x) for x in moments] + [jnp.int32(COUNT)]
    targs += [torch.from_numpy(x.copy()) for x in moments] + [torch.tensor(COUNT,
                                                                            dtype=torch.int32)]
    return jargs, targs, W


def _hp(form, stochastic=False):
    kw = dict(alpha=ALPHA)
    if form.startswith("adam8"):
        kw["stochastic"] = stochastic
    if form.endswith("apply"):
        kw.update(wd=WD)
    return kw


# ---------------------------------------------------------------------------
# 1. the six dispatchers: which route, and the plain fallback against JAX
# ---------------------------------------------------------------------------


def test_failing_shapes_fail_and_fitting_shapes_fit():
    """The routes below are the ones the reference's own predicate picks."""
    for side, right in (("left", False), ("right", True)):
        for shape, fits in ((FITS[side], True), (FAILS[side], False)):
            m, r, n = shape[-3:]
            kept, swept = (n, m) if right else (m, n)
            for itemsize in (2, 4):
                assert jgf.fits_vmem(kept, r, swept, itemsize) is fits
                assert tk.fits_vmem(kept, r, swept, itemsize) is fits


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("fits", [True, False])
@pytest.mark.parametrize("p_int4", [False, True])
def test_dispatch_takes_the_reference_route(monkeypatch, form, side, fits, p_int4):
    """A spy on each route: where fits_vmem holds, the kernel wrapper runs
    (on CPU tensors it runs the plain step itself); where it fails, only the
    plain step runs, and neither the wrapper nor the tiled projections (B4,
    B5), which are the fp32 emit step's fallback only."""
    calls = {"kernel": 0, "plain": 0, "project": 0, "back": 0}

    def spy(key, fn):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    name = _name(form, side)
    monkeypatch.setattr(tk, name, spy("kernel", getattr(tk, name)))
    monkeypatch.setattr(tk, name + "_plain", spy("plain", getattr(tk, name + "_plain")))
    monkeypatch.setattr(ops, "galore_project", spy("project", tp.galore_project))
    monkeypatch.setattr(ops, "galore_project_back", spy("back", tp.galore_project_back))
    _, args, _ = _leaf_args(form, (FITS if fits else FAILS)[side], side, p_int4)
    kw = _hp(form)
    if form.endswith("apply"):
        kw["eta"] = torch.tensor(ETA)
    tk.reset_launch_counts()
    getattr(ops, name)(*args, **kw)
    assert calls == {"kernel": int(fits), "plain": 1, "project": 0, "back": 0}
    assert all(fn.launches == 0 for fn in tk.WRAPPERS)  # CPU tensors: no launch counted


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("p_int4", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
def test_adam8_fallback_matches_jax(side, p_int4, stochastic):
    """ops.galore_fused_adam8_step[_right] at a shape that fails fits_vmem ==
    JAX's ops step (use_pallas=True, interpret=True: its ref.* fallback
    there): G̃ and scales within 1e-5·max, codes at most one apart; codes and
    scales updated in place."""
    jargs, targs, _ = _leaf_args("adam8", FAILS[side], side, p_int4)
    name = _name("adam8", side)
    want = getattr(jops, name)(*jargs, **_hp("adam8", stochastic), use_pallas=True,
                               interpret=True)
    got = getattr(ops, name)(*targs, **_hp("adam8", stochastic))
    assert all(a is b for a, b in zip(got[1:], targs[2:6]))
    tag = f"{side} int4 P {p_int4} stochastic {stochastic}"
    for what, a, b in zip(["update", "mq", "ms", "vq", "vs"], got, want):
        if a.dtype == torch.uint8:
            assert_codes_close(a, b, f"{tag} {what}")
        else:
            _assert_close(a, b, f"{tag} {what}")


@pytest.mark.parametrize("form", ["apply", "adam8_apply"])
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("p_int4", [False, True])
@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
def test_apply_fallback_matches_jax(form, side, p_int4, w_dtype):
    """The fp32- and int8-moment apply dispatchers at a shape that fails
    fits_vmem == JAX's ops step (Pallas-interpret dispatch, ref.* fallback
    there): f32 W' - W within 2e-5·max, bf16 W' within one ulp, moments
    within 1e-5·max (codes at most one apart); W and the moments updated in
    place."""
    wdt = getattr(torch, w_dtype)
    jargs, targs, W = _leaf_args(form, FAILS[side], side, p_int4, wdt)
    w0 = W.clone()
    name = _name(form, side)
    want = getattr(jops, name)(*jargs, **_hp(form), eta=jnp.float32(ETA), use_pallas=True,
                               interpret=True)
    got = getattr(ops, name)(*targs, **_hp(form), eta=torch.tensor(ETA))
    assert got[0] is W and W.dtype == wdt
    assert all(a is b for a, b in zip(got[1:], targs[3:-1]))
    tag = f"{form} {side} int4 P {p_int4} W {w_dtype}"
    # bf16 W: one ulp, plus 2e-5·max|W' - W| where W' is near 0 (the f32 sum
    # cancels there, and XLA's and torch's matmuls sum in other orders at
    # this rank: 3 of 393,216 elements at |W'| < 5e-8 are more than one ulp
    # apart), the card checks' rule for bf16 W
    assert_weight_close(W, np.asarray(want[0]).astype(np.float32), w0, f"{tag} W", tol=2e-5,
                        ulps=int(wdt == torch.bfloat16))
    for i, (a, b) in enumerate(zip(got[1:], want[1:])):
        if a.dtype == torch.uint8:
            assert_codes_close(a, b, f"{tag} moment {i}")
        else:
            _assert_close(a, b, f"{tag} moment {i}")


# ---------------------------------------------------------------------------
# 2. activation checkpointing is refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["full", "scores", "names"])
def test_check_ported_refuses_remat(remat):
    """The reference checkpoints activations for remat != "none"; the port
    does not yet, so it refuses such a config instead of running it with the
    reference's numerics but not its memory."""
    cfg = dataclasses.replace(get_config("llama_60m", smoke=True), remat=remat)
    with pytest.raises(NotImplementedError, match="remat"):
        TM.check_ported(cfg)
    with pytest.raises(NotImplementedError, match="remat"):
        TM.init_params(cfg, seed=0, device="cpu")
    TM.check_ported(dataclasses.replace(cfg, remat="none"))


# ---------------------------------------------------------------------------
# 3. split TF32: a CPU model of the tiled projections' arithmetic
# ---------------------------------------------------------------------------


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a TF32 ulp at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4,
                  one + ulp + ulp / 2, np.float32(3.0), np.float32(0.0)], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + ulp, one + 2 * ulp, 3.0, 0.0],
                    np.float32)
    np.testing.assert_array_equal(tf32_rna(x), want)
    r = tf32_rna(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    assert np.all(r.view(np.uint32) & np.uint32(0x1FFF) == 0)


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_tf32_product_meets_the_kernel_gate(case):
    """B4 (R = PᵀG, G f32 in three passes or bf16 in two) and B5 (G̃ = PN,
    three passes) modelled in split TF32 at a small shape with a ragged
    k-tile: within 1e-5·max|want| + 1e-5·|want| of the float64 product, where
    one TF32 pass is not."""
    _, _, A, B, exact = split_tf32_inputs(case)
    want = A.astype(np.float64) @ B.astype(np.float64)
    got = split_tf32_matmul(A, B, b_exact=exact)
    assert within_gate(got, want), float(np.abs(got - want).max())
    one_pass = tf32_rna(A).astype(np.float64) @ tf32_rna(B).astype(np.float64)
    assert not within_gate(one_pass, want)
