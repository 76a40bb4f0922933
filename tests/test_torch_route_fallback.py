"""The plain fallback of the port's int8-moment and weight-apply
dispatchers (kernels/ops.py) against the JAX package: at a shape that fails
the reference's ``fits_vmem`` each dispatcher matches JAX's ``ops.*`` with
``use_pallas=True, interpret=True``, which runs the reference's plain
fallback there. Which route each dispatcher takes is
tests/test_torch_route.py's."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_cuda import assert_codes_close, assert_weight_close  # noqa: E402
from test_torch_quant import _assert_close  # noqa: E402
from test_torch_route import ETA, FAILS, _hp, _leaf_args, _name  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401


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
