"""Routing of the port's GaLore step forms, the ``remat`` policies, and a
CPU model of the split-TF32 arithmetic of the tiled projections.

1. The six int8-moment and weight-apply dispatchers of kernels/ops.py take
   the reference's route on both sides of ``fits_vmem`` (route spies); at a
   shape that fails it each matches JAX's ``ops.*`` in
   tests/test_torch_route_fallback.py.
2. ``check_ported`` accepts remat "full" (each layer group recomputed in the
   backward) and refuses the reference's "scores" and "names" policies.
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
from repro.quant import codec as jcodec  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import galore_fused as tk  # noqa: E402
from repro_torch.kernels import galore_project as tp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_cuda import (  # noqa: E402
    adam8_inputs,
    SPLIT_CASES,
    fused_inputs,
    split_tf32_inputs,
    split_tf32_matmul,
    tf32_rna,
    within_gate,
)
from torch_threads import one_thread  # noqa: E402,F401

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
# 1. the six dispatchers: which route
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


# ---------------------------------------------------------------------------
# 2. activation checkpointing: "full" ported, "scores" and "names" refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["full", "scores", "names"])
def test_check_ported_refuses_remat(remat):
    """The reference's remat policies: "full" (recompute each layer group in
    the backward) runs in the port, its loss and gradients bit for bit the
    un-checkpointed run's; "scores" and "names" (which only the reference's
    TPU hill-climbing tool sets) are refused instead of being run with the
    reference's numerics but not its memory."""
    cfg = dataclasses.replace(get_config("llama_60m", smoke=True), remat=remat)
    if remat == "full":
        TM.check_ported(cfg)
        params = TM.init_params(cfg, seed=0, device="cpu")
        batch = {"tokens": torch.arange(64).reshape(2, 32) % cfg.vocab_size}
        runs = []
        for c in (cfg, dataclasses.replace(cfg, remat="none")):
            loss, _ = TM.loss_fn(c, params, batch)
            runs.append([loss] + list(torch.autograd.grad(loss, tree_leaves(params))))
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        return
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
