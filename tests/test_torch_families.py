"""The attention-decoder families in the port against the JAX package, on the
smoke configs (f32), from the same weights and numpy-made batches: dense
with QKV bias and MQA/GQA (qwen2, granite, internlm2, minitron), vlm with
M-RoPE and media embeddings (qwen2-vl), MoE (grok-1, and Llama-4 Scout with
chunked iRoPE attention).

1. Logits, loss, aux_loss and every gradient leaf of each smoke config
   within 1e-5·max (vlm with (3, B, S) positions whose rows differ).
2. ``apply_moe`` and its gradients with capacity drops.
3. Chunked attention blocks cross-chunk flow (the reference's own check).
4. Prefill then decode against the full forward (ample MoE capacity).
5. ``remat="full"`` bit for bit ``"none"``.
6. The contiguous decode of a chunked layer at cache lengths that are not a
   multiple of the chunk, and shorter than it, against the full forward
   (the reference's decode window is wrong there, ROADMAP C.12).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, ModelConfig, get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.utils import tree_leaves, tree_leaves_with_path  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401


# the attention decoders; the ssm and hybrid families have files of their own
DECODER_ARCHS = [a for a in ARCH_IDS if get_config(a, smoke=True).family in ("dense", "moe", "vlm")]


def _close(got, want, name, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-6), err_msg=name)


def _np_batch(cfg, seed, B=2, S=32):
    """tokens and a loss mask; under vlm (3, B, S) positions with differing
    rows (temporal, height, width of a 4-wide grid after the media) and
    media embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "loss_mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
    if cfg.family == "vlm":
        s = np.arange(S)
        rows = np.stack([s // 4, s // 2 % 3, s % 4 + s // 8]).astype(np.int32)
        batch["positions"] = np.broadcast_to(rows[:, None], (3, B, S)).copy()
        batch["media"] = (0.1 * rng.standard_normal((B, cfg.media_embeds, cfg.d_model))
                          ).astype(np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
            for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _jax_flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# 1. every smoke config: logits, loss, aux_loss, gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_family_loss_and_grads_match_jax(arch):
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    params = TM.init_params(cfg, seed=0, device="cpu")
    jparams = params_to_numpy(params)  # the same weights on both sides
    batch = _np_batch(cfg, seed=1)
    jb = _jax_batch(batch)

    def f(p):
        total, metrics = JM.loss_fn(jcfg, p, jb)
        return total, (metrics, JM.forward(jcfg, p, jb)[0])

    (jtotal, (jmetrics, jlogits)), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(jparams)

    tb = _torch_batch(batch)
    total, metrics = TM.loss_fn(cfg, params, tb)
    _close(TM.forward(cfg, params, tb), jlogits, "logits")
    _close(total, jtotal, "total")
    _close(metrics["loss"], jmetrics["loss"], "loss")
    _close(metrics["aux_loss"], jmetrics["aux_loss"], "aux_loss")
    assert (float(metrics["aux_loss"]) > 0) == (cfg.n_experts > 0)
    leaves = tree_leaves_with_path(params)
    grads = torch.autograd.grad(total, [p for _, p in leaves])
    jflat = _jax_flat(jgrads)
    assert sorted(jflat) == [path for path, _ in leaves]
    for (path, p), g in zip(leaves, grads):
        assert g.dtype == p.dtype, path  # the f32 router inside any tree
        _close(g, jflat[path], f"grad {path}")


# ---------------------------------------------------------------------------
# 2. the MoE layer with capacity drops
# ---------------------------------------------------------------------------


def test_apply_moe_with_drops_matches_jax():
    """capacity_factor 0.5, top-2 of 4: a share of the copies is dropped; the
    output, the aux loss and the gradients of x and of every expert leaf
    (through the gather adjoint) within 1e-5·max of the reference's."""
    kw = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
              d_ff=32, vocab_size=64, n_experts=4, experts_per_token=2, capacity_factor=0.5,
              dtype="float32")
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    p = tmoe.init_moe(torch.Generator().manual_seed(4), cfg, torch.float32)
    jp = params_to_numpy(p)
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    x = np.random.default_rng(4).standard_normal((2, 32, 16)).astype(np.float32)

    def jloss(p, x):
        y, aux = jmoe.apply_moe(jcfg, p, x)
        return jnp.sum(y ** 2) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                             has_aux=True))(jp, x)
    assert tmoe.capacity_for(cfg, 32) == jmoe.capacity_for(jcfg, 32) == 8  # 64 copies, 32 slots
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.apply_moe(cfg, p, xt)
    _close(y, jy, "y")
    _close(aux, jaux, "aux")
    leaves = tree_leaves_with_path(p)
    gs = torch.autograd.grad((y ** 2).sum() + aux, [xt] + [t for _, t in leaves])
    _close(gs[0], jgx, "grad x")
    jflat = _jax_flat(jgp)
    for (path, _), g in zip(leaves, gs[1:]):
        _close(g, jflat[path], f"grad {path}")


# ---------------------------------------------------------------------------
# 3. chunked attention
# ---------------------------------------------------------------------------


def _chunked_granite(n_layers):
    return dataclasses.replace(get_config("granite_20b", smoke=True), n_layers=n_layers,
                               attention_chunk=8, sub_quadratic=True)


def test_chunked_attention_blocks_cross_chunk_flow():
    """A token changed in chunk 0 leaves every logit of chunk 1 unchanged and
    changes those after it in chunk 0 (tests/test_models.py's check, in the
    port)."""
    cfg = _chunked_granite(4)
    params = TM.init_params(cfg, seed=5, device="cpu")
    t1 = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 16)))
    t2 = t1.clone()
    t2[0, 2] = (t2[0, 2] + 7) % cfg.vocab_size
    with torch.no_grad():
        l1, l2 = (TM.forward(cfg, params, {"tokens": t}) for t in (t1, t2))
    assert torch.equal(l1[0, 8:], l2[0, 8:])
    assert float((l1[0, 2:8] - l2[0, 2:8]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# 4. prefill then decode against the full forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2_7b", "grok_1_314b", "llama4_scout_17b_a16e"])
def test_prefill_decode_matches_full_forward(arch):
    """Prefill 11 tokens into a contiguous cache of 16, then decode the other
    five one at a time: each step's logits within 1e-5·max of the full
    forward's (MoE capacity 8.0, so nothing drops at any length)."""
    cfg = get_config(arch, smoke=True)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    params = TM.init_params(cfg, seed=1, device="cpu")
    B, S, k = 2, 16, 11
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        full = TM.forward(cfg, params, {"tokens": tokens})
        cache = TM.init_cache(cfg, B, S, device="cpu")
        pre, cache = TM.forward_cached(cfg, params, {"tokens": tokens[:, :k]}, cache=cache,
                                       cache_pos=0)
        _close(pre[:, -1], full[:, k - 1], "prefill")
        for pos in range(k, S):
            dec, cache = TM.forward_cached(cfg, params, {"tokens": tokens[:, pos:pos + 1]},
                                           cache=cache, cache_pos=pos)
            _close(dec[:, 0], full[:, pos], f"decode at {pos}")


# ---------------------------------------------------------------------------
# 5. remat
# ---------------------------------------------------------------------------


def test_remat_full_equals_none_bitwise():
    """Llama-4 Scout smoke (MoE, one iRoPE group of four layers): the loss,
    aux loss and every gradient leaf with remat "full" equal remat "none"'s
    bit for bit."""
    cfg = get_config("llama4_scout_17b_a16e", smoke=True)
    params = TM.init_params(cfg, seed=2, device="cpu")
    tb = _torch_batch(_np_batch(cfg, seed=2))
    runs = []
    for remat in ("full", "none"):
        total, metrics = TM.loss_fn(dataclasses.replace(cfg, remat=remat), params, tb)
        runs.append([total, metrics["aux_loss"]]
                    + list(torch.autograd.grad(total, tree_leaves(params))))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ---------------------------------------------------------------------------
# 6. the chunked contiguous decode at any cache length (C.12)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len,prefill", [(16, 5), (12, 5), (6, 3)])
def test_chunked_decode_window_at_any_cache_length(max_len, prefill):
    """granite smoke, one layer, chunk 8: prefill, then decode to the end of a cache of 16, 12 (not a
    multiple of the chunk) or 6 (shorter than it) tokens — crossing the chunk
    boundary at 16 and 12 — each step within 1e-5·max of the full forward.
    The reference's contiguous decode is 4.80 off at length 12 and raises at
    6 (ROADMAP C.12); the port's is held to the full forward."""
    cfg = _chunked_granite(1)
    params = TM.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (1, max_len)))
    with torch.no_grad():
        full = TM.forward(cfg, params, {"tokens": tokens})
        cache = TM.init_cache(cfg, 1, max_len, device="cpu")
        pre, cache = TM.forward_cached(cfg, params, {"tokens": tokens[:, :prefill]},
                                       cache=cache, cache_pos=0)
        _close(pre[:, -1], full[:, prefill - 1], "prefill")
        for pos in range(prefill, max_len):
            dec, cache = TM.forward_cached(cfg, params, {"tokens": tokens[:, pos:pos + 1]},
                                           cache=cache, cache_pos=pos)
            _close(dec[:, 0], full[:, pos], f"decode at {pos} of {max_len}")

