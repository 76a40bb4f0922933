"""How far the SSM families' f32 gradients are determined by rounding alone,
on the CPU (a script, not a test; it imports the JAX package, so it lives
with the tests):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/ssm_conditioning.py mamba2_130m
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/ssm_conditioning.py jamba_1_5_large_398b

On the smoke config, the port's weights, a (2, 13) batch (the seeds of
tests/test_torch_ssm.py / test_torch_hybrid.py), it prints for the worst
gradient leaves, each as max|Δ| over 1e-5·max|g| of the leaf: the port's f32
gradients against JAX's; JAX's f32 gradients against a float64 evaluation
of the port (every f32 cast of the port made a float64 one); and JAX's f32
gradients under a one-ulp change of every weight (each up or down at
random). Where the last two exceed 1 the reference's own gradients are not
determined to 1e-5·max, and a test holds them a layer at a time.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import model as JM
from repro_torch.bridge import params_to_numpy
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM
from repro_torch.utils import tree_leaves_with_path, tree_map


def _flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads(cfg, params, batch):
    total, _ = TM.loss_fn(cfg, params, batch)
    leaves = tree_leaves_with_path(params)
    return dict(zip([k for k, _ in leaves],
                    (g.double().numpy() for g in torch.autograd.grad(total, [v for _, v in leaves]))))


def main(arch):
    torch.set_num_threads(1)
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    params = TM.init_params(cfg, seed=0, device="cpu")
    jp = params_to_numpy(params)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 13))
    mask = (rng.random((2, 13)) > 0.1).astype(np.float32)
    jb = {"tokens": jnp.asarray(tokens, jnp.int32), "loss_mask": jnp.asarray(mask)}
    grad = jax.jit(jax.grad(lambda p: JM.loss_fn(jcfg, p, jb)[0]))
    g_jax = _flat(grad(tree_map(jnp.asarray, jp)))
    nudge = np.random.default_rng(7)
    g_nudged = _flat(grad(tree_map(lambda a: jnp.asarray(np.nextafter(
        a, np.where(nudge.random(a.shape) < 0.5, -np.inf, np.inf).astype(a.dtype))), jp)))
    batch = {"tokens": torch.from_numpy(tokens), "loss_mask": torch.from_numpy(mask)}
    g32 = _port_grads(cfg, params, batch)
    # the port in float64: every f32 cast and f32 zero made a float64 one
    f32_cast, zeros = torch.Tensor.float, torch.zeros
    torch.Tensor.float = lambda self: self.double()
    torch.zeros = lambda *a, **k: zeros(*a, **{**k, "dtype": torch.float64}
                                        if k.get("dtype") == torch.float32 else k)
    try:
        g64 = _port_grads(cfg, tree_map(lambda t: t.detach().double().requires_grad_(True),
                                        params),
                          {**batch, "loss_mask": batch["loss_mask"].double()})
    finally:
        torch.Tensor.float, torch.zeros = f32_cast, zeros
    rows = []
    for k, want in g_jax.items():
        unit = 1e-5 * np.abs(want).max()
        rows.append((np.abs(g32[k] - want).max() / unit, np.abs(want - g64[k]).max() / unit,
                     np.abs(g_nudged[k] - want).max() / unit, k))
    print(f"{arch}: max|Δ| / 1e-5·max|g| — port f32 vs JAX | JAX vs port f64 | JAX one-ulp "
          f"weights vs JAX")
    for row in sorted(rows)[-8:]:
        print("  %8.2f %8.2f %8.2f  %s" % row)
    print("  largest: %.2f %.2f %.2f" % tuple(max(r[i] for r in rows) for i in range(3)))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "mamba2_130m")
