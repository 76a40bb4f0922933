"""Port GaLore: plans, one GaLore-Adam update at a fixed projector, and the
SVD refresh, against the JAX package on the same inputs."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core.galore import galore as jax_galore  # noqa: E402
from repro.core.galore import plan_for_params  # noqa: E402
from repro.core.projector import compute_projector as jax_compute_projector  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adam import scale_by_adam as jax_scale_by_adam  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    galore_state_from_numpy,
    galore_state_to_numpy,
    params_from_numpy,
)
from repro_torch.configs.base import GaLoreConfig  # noqa: E402
from repro_torch.core.galore import galore  # noqa: E402
from repro_torch.core.projector import subspace_overlap  # noqa: E402
from repro_torch.core.subspace import (  # noqa: E402
    SubspaceManager,
    compute_leaf_projector,
    proj_shape,
)
from repro_torch.utils import tree_leaves_with_path, tree_map  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401


def _smoke_params():
    cfg = jax_get_config("llama_60m", smoke=True)
    return jax.tree_util.tree_map(np.asarray, JM.init_params(cfg, jax.random.PRNGKey(0)))


def _by_path(jtree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(jtree, is_leaf=is_leaf)[0]
    return {".".join(str(k.key) for k in path): x for path, x in flat}


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)


def test_plans_match_reference():
    params = _smoke_params()
    jplans = _by_path(plan_for_params(params, JGaLoreConfig(rank=16)),
                      is_leaf=lambda x: hasattr(x, "galore"))
    tparams = params_from_numpy(params, "cpu")
    plans = SubspaceManager(GaLoreConfig(rank=16)).plans(tparams)
    for path, plan in tree_leaves_with_path(plans):
        want = jplans[path]
        assert (plan.galore, plan.side, plan.rank) == (want.galore, want.side, want.rank), path
    sides = {p: pl.side for p, pl in tree_leaves_with_path(plans) if pl.galore}
    assert sides["blocks.ffn.down"] == "right" and sides["blocks.attn.wq"] == "left"
    assert sum(pl.galore for _, pl in tree_leaves_with_path(plans)) == 7


@pytest.mark.parametrize("fused", [True, False])
def test_update_at_fixed_projector_matches_jax(fused):
    """Step 0 refreshes P in JAX; the state is bridged over, and the step-1
    update (no refresh, T=10) runs on both sides from the same P."""
    params = _smoke_params()
    jcfg = JGaLoreConfig(rank=16, update_freq=10, scale=0.25)
    jopt = (jax_galore(jax_scale_by_adam(), jcfg, fused_adam=True, b1=0.9, b2=0.999, eps=1e-8)
            if fused else jax_galore(jax_scale_by_adam(), jcfg))
    jupdate = jax.jit(jopt.update)
    jstate = jopt.init(params)
    _, jstate = jupdate(_grads(params, 1), jstate, params)
    g2 = _grads(params, 2)
    state = galore_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate), "cpu")
    jupd, jstate = jupdate(g2, jstate, params)

    opt = galore(GaLoreConfig(rank=16, update_freq=10, scale=0.25),
                 b1=0.9, b2=0.999, eps=1e-8, fused=fused)
    tparams = params_from_numpy(params, "cpu")
    assert sorted(opt.init(tparams)) == ["inner", "key", "proj", "step"]
    upd, state = opt.update(tree_map(torch.from_numpy, g2), state, tparams)

    jupd = _by_path(jupd)
    jm = _by_path(jstate["inner"]["m"])
    jv = _by_path(jstate["inner"]["v"])
    for path, u in tree_leaves_with_path(upd):
        want = np.asarray(jupd[path])
        np.testing.assert_allclose(u.numpy(), want, rtol=2e-5,
                                   atol=2e-5 * np.abs(want).max(), err_msg=path)
    for name, tree, jflat in (("m", state["inner"]["m"], jm), ("v", state["inner"]["v"], jv)):
        for path, x in tree_leaves_with_path(tree):
            want = np.asarray(jflat[path])
            np.testing.assert_allclose(x.numpy(), want, rtol=2e-5,
                                       atol=2e-5 * np.abs(want).max(), err_msg=f"{name} {path}")
    assert state["step"] == 2 and int(state["inner"]["count"]) == 2
    back = galore_state_to_numpy(state)
    assert back["proj"]["blocks"]["ffn"]["down"].shape == (2, 64, 16)


@pytest.mark.parametrize("path", ["blocks.ffn.up", "blocks.ffn.down"])
def test_refresh_spans_jax_subspace(path):
    """The refresh of a left (up) and a right (down) stacked leaf spans the
    JAX SVD projector's subspace (column signs may differ)."""
    params = _smoke_params()
    plan = dict(tree_leaves_with_path(
        SubspaceManager(GaLoreConfig(rank=16)).plans(params_from_numpy(params, "cpu"))))[path]
    shape = _by_path(params)[path].shape  # (2, m, n)
    rng = np.random.default_rng(3)
    # a gradient with a decaying spectrum, so the top-16 subspace is well defined
    U = np.linalg.qr(rng.standard_normal(shape[:1] + (shape[1],) * 2))[0]
    W = np.linalg.qr(rng.standard_normal(shape[:1] + (shape[2],) * 2))[0]
    k = min(shape[1:])
    G = ((U[..., :k] * np.logspace(1, -2, k)) @ np.swapaxes(W[..., :k], -1, -2)).astype(np.float32)
    P = compute_leaf_projector(torch.from_numpy(G), plan, GaLoreConfig(rank=16))
    G_in = G if plan.side == "left" else np.swapaxes(G, -1, -2)
    P_ref = np.asarray(jax_compute_projector(jnp.asarray(G_in), 16, method="svd"))
    assert tuple(P.shape) == proj_shape(torch.empty(shape), plan) == P_ref.shape
    overlap = subspace_overlap(P, torch.tensor(P_ref))
    assert float(overlap.min()) > 0.999, overlap
