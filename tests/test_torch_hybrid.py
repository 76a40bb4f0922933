"""The hybrid family (Jamba's period-8 blocks, ``jamba_1_5_large_398b``) in
the port against the JAX package, on the smoke config (f32: one block of 8
sub-layers, attention at offset 4 and the SSD layer elsewhere, MoE of 4
experts top-2 on the odd sub-layers), from the port's weights handed across
as numpy.

1. Logits, loss and aux_loss within 1e-5·max at S = 13; the parameter tree
   is a tuple of 8 sub-layer dicts whose leaves carry the reference's path
   names (``blocks.0.ffn.down``, ``blocks.4.mix.wq``). Each sub-layer's
   output, MoE loss and gradients (of x and of every leaf) within 1e-5·max
   of the reference's on shared inputs.
2. Prefill then decode: equal to the full forward at a capacity at which no
   token drops; at the default capacity (which drops tokens, and sizes each
   expert from the call's length) equal to JAX's own prefill and decode.
3. A JAX GaLore state on the tuple tree restores in the port bit for bit;
   the port's state after one fused step restores in JAX bit for bit.
4. A depth that is not whole blocks raises; the Server's mixed-length batch
   and the train launcher (``--layers 8``) run.
"""
import dataclasses
import functools
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.distributed import step as jstep  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.subspace import SubspaceManager  # noqa: E402
from repro_torch.distributed import step as tstep  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import stacks as tstacks  # noqa: E402
from repro_torch.utils import tree_leaves_with_path, tree_map  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ARCH = "jamba_1_5_large_398b"


def _close(got, want, name, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-6), err_msg=name)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x, np.int32) if isinstance(x, int) else np.asarray(x)


def _flat(tree):
    return {k: _np(v) for k, v in tree_leaves_with_path(tree)}


def _jflat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def model():
    """(port cfg, port params, JAX cfg, the same params as JAX arrays)."""
    cfg = get_config(ARCH, smoke=True)
    params = TM.init_params(cfg, seed=0, device="cpu")
    return cfg, params, jax_get_config(ARCH, smoke=True), tree_map(jnp.asarray,
                                                                     params_to_numpy(params))


def test_hybrid_logits_loss_and_aux_match_jax(model):
    """Logits, loss and aux_loss within 1e-5·max of JAX's at S = 13; the
    port's gradient tree has the reference's leaves (names, shapes, dtypes),
    each finite."""
    cfg, params, jcfg, jparams = model
    assert isinstance(params["blocks"], tuple) and len(params["blocks"]) == 8
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 13))
    mask = (rng.random((2, 13)) > 0.1).astype(np.float32)
    jb = {"tokens": jnp.asarray(tokens, jnp.int32), "loss_mask": jnp.asarray(mask)}

    def f(p):
        total, metrics = JM.loss_fn(jcfg, p, jb)
        return total, metrics, JM.forward(jcfg, p, jb)[0]

    jtotal, jmetrics, jlogits = jax.jit(f)(jparams)
    tb = {"tokens": torch.from_numpy(tokens), "loss_mask": torch.from_numpy(mask)}
    total, metrics = TM.loss_fn(cfg, params, tb)
    _close(TM.forward(cfg, params, tb), jlogits, "logits")
    _close(total, jtotal, "total")
    _close(metrics["loss"], jmetrics["loss"], "loss")
    _close(metrics["aux_loss"], jmetrics["aux_loss"], "aux_loss")
    assert float(metrics["aux_loss"]) > 0
    leaves = tree_leaves_with_path(params)
    grads = torch.autograd.grad(total, [p for _, p in leaves])
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): x.shape
            for path, x in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert sorted(want) == [path for path, _ in leaves]
    assert {"blocks.0.ffn.down", "blocks.1.ffn.router", "blocks.4.mix.wq",
            "blocks.3.mix.out_proj"} <= set(want)
    for (path, p), g in zip(leaves, grads):
        assert g.dtype == p.dtype and tuple(g.shape) == want[path], path
        assert torch.isfinite(g).all(), path


@functools.lru_cache(maxsize=None)
def _jax_sublayer_grad(kind, is_moe):
    """The reference block body's sub-layer (stacks.apply_jamba_stack) at one
    offset's kind — pre-norm mixer, then pre-norm FFN, each residual — with
    the loss sum(y·w) + aux: jitted value_and_grad (p, x, w, angles) ->
    ((loss, (y, aux)), (dp, dx)), one compile per kind."""
    jcfg = jax_get_config(ARCH, smoke=True)

    def loss(p, x, w, angles):
        h = jlayers.apply_norm(jcfg, p["ln1"], x)
        if kind == "attn":
            mix, _ = jattn.attend(jcfg, p["mix"], h, angles=angles, causal=True)
        else:
            mix, _ = jssm.apply_ssm(jcfg, p["mix"], h)
        x = x + mix
        h = jlayers.apply_norm(jcfg, p["ln2"], x)
        if is_moe:
            out, aux = jmoe.apply_moe(jcfg, p["ffn"], h)
        else:
            out, aux = jlayers.apply_mlp(jcfg, p["ffn"], h), jnp.zeros((), jnp.float32)
        y = x + out
        return jnp.sum(y * w) + aux, (y, aux)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


@pytest.mark.parametrize("offset", range(8))
def test_sublayer_grads_match_jax(model, offset):
    """Each of the block's 8 sub-layers on the same input x (B = 2, S = 13)
    and the same output cotangent: the output, the MoE loss and the
    gradients of x and of every leaf within 1e-5·max of the reference's.

    Held per sub-layer, not through the whole model: this random model's
    f32 gradients move by several times 1e-5·max under rounding alone
    (JAX's own, by up to 9.6× against a float64 evaluation and 17.9× under
    one-ulp changes of its weights; tests/ssm_conditioning.py), so only a
    sub-layer's gradients on shared inputs are determined to that
    tolerance."""
    cfg, params, jcfg, _ = model
    kind, is_moe = tstacks._jamba_block_structure(cfg)[offset]
    assert (kind == "attn") == (offset == cfg.attn_offset) and is_moe == (offset % 2 == 1)
    sp = tree_map(lambda t: t.detach()[0].clone().requires_grad_(True), params["blocks"][offset])
    rng = np.random.default_rng(10 + offset)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    jangles = jrope.rope_angles(jrope.positions_for(jcfg, 2, 13), jcfg.resolved_head_dim,
                                jcfg.rope_theta)
    (_, (jy, jaux)), (jgp, jgx) = _jax_sublayer_grad(kind, is_moe)(
        tree_map(jnp.asarray, params_to_numpy(sp)), x, w, jangles)
    xt = torch.from_numpy(x).requires_grad_(True)
    angles = TM._angles(cfg, None, 13, 2, xt.device)
    y, aux = tstacks.jamba_sublayer(cfg, kind, is_moe, sp, xt, angles=angles)
    aux = torch.zeros(()) if aux is None else aux
    _close(y, jy, "y")
    _close(aux, jaux, "aux")
    leaves = tree_leaves_with_path(sp)
    gs = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux, [xt] + [t for _, t in leaves])
    _close(gs[0], jgx, "grad x")
    jflat = _jflat(jgp)
    assert sorted(jflat) == [path for path, _ in leaves]
    for (path, _), g in zip(leaves, gs[1:]):
        _close(g, jflat[path], f"grad {path}")


def _prefill_decode(cfg, params, tokens, S):
    """The port's prefill of S tokens and teacher-forced decode of the rest:
    (prefill logits (B, S, V), decode logits (B, n − S, V))."""
    cache = TM.init_cache(cfg, tokens.shape[0], tokens.shape[1], device="cpu")
    with torch.inference_mode():
        pre, cache = TM.forward_cached(cfg, params, {"tokens": torch.from_numpy(tokens[:, :S])},
                                       cache=cache, cache_pos=0)
        dec = [TM.forward_cached(cfg, params, {"tokens": torch.from_numpy(tokens[:, p:p + 1])},
                                 cache=cache, cache_pos=p)[0][:, 0]
               for p in range(S, tokens.shape[1])]
    return pre, torch.stack(dec, 1)


def test_prefill_decode_matches_full_forward(model):
    """At capacity_factor 100 (no token drops) an 11-token prefill and 3
    decode steps equal the full forward within 1e-5·max."""
    _, params, _, _ = model
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), capacity_factor=100.0)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 14))
    with torch.no_grad():
        full = TM.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    pre, dec = _prefill_decode(cfg, params, tokens, 11)
    _close(pre, full[:, :11], "prefill")
    _close(dec, full[:, 11:], "decode")


def test_prefill_decode_at_default_capacity_matches_jax(model):
    """At the default capacity the prefill and decode drop other tokens than
    the full forward (the reference's capacity follows the call's length);
    the port's prefill and decode logits equal JAX's within 1e-5·max."""
    cfg, params, jcfg, jparams = model
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 14))
    pre, dec = _prefill_decode(cfg, params, tokens, 11)
    jcache = JM.init_cache(jcfg, 2, 14)
    jf = jax.jit(lambda p, c, t, pos: JM.forward(jcfg, p, {"tokens": t}, cache=c,
                                                 cache_pos=pos))
    jpre, _, jcache = jf(jparams, jcache, jnp.asarray(tokens[:, :11], jnp.int32), 0)
    jdec = []
    for pos in range(11, 14):
        logits, _, jcache = jf(jparams, jcache, jnp.asarray(tokens[:, pos:pos + 1], jnp.int32),
                               pos)
        jdec.append(np.asarray(logits)[:, 0])
    _close(pre, jpre, "prefill vs JAX")
    _close(dec, np.stack(jdec, 1), "decode vs JAX")


def test_checkpoint_of_tuple_tree_both_ways(model, tmp_path):
    """JAX's GaLore-AdamW state on the tuple tree, saved by the JAX manager,
    restores in the port bit for bit (projectors on the SSD, attention and
    4-D expert leaves); after one fused port step the port's checkpoint
    restores in the JAX manager bit for bit."""
    cfg, params, jcfg, jparams = model
    g = dict(rank=16, update_freq=10)
    common = dict(optimizer="adamw", weight_decay=0.01, total_steps=4, warmup_steps=1)
    _, jopt = jstep.make_train_step(jcfg, JTrainConfig(galore=JGaLoreConfig(**g), **common))
    jtree = {"params": jparams, "opt_state": jopt.init(jparams)}
    JCheckpointManager(str(tmp_path / "jax"), async_save=False).save(0, jtree, block=True)
    tc = TrainConfig(galore=GaLoreConfig(**g), galore_fused_adam=True, **common)
    step_fn, opt = tstep.make_train_step(cfg, tc)
    p0 = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    restored = CheckpointManager(str(tmp_path / "jax"), async_save=False).restore(
        0, {"params": p0, "opt_state": opt.init(p0)})
    _bitwise(_flat(restored), _jflat(jtree))
    plans = dict(tree_leaves_with_path(SubspaceManager(tc.galore).plans(restored["params"])))
    for leaf in ("blocks.0.mix.in_x", "blocks.4.mix.wq", "blocks.1.ffn.gate",
                 "blocks.0.ffn.down"):
        assert plans[leaf].galore, leaf
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    new_p, new_s, metrics = step_fn(restored["params"], restored["opt_state"],
                                    {"tokens": torch.from_numpy(tokens)})
    assert np.isfinite(float(metrics["loss"]))
    port_tree = {"params": new_p, "opt_state": new_s}
    CheckpointManager(str(tmp_path / "port"), async_save=False).save(1, port_tree, block=True)
    back = JCheckpointManager(str(tmp_path / "port"), async_save=False).restore(1, jtree)
    _bitwise(_jflat(back), _flat(port_tree))


def test_depth_not_whole_blocks_raises(model):
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), n_layers=12)
    with pytest.raises(ValueError, match="whole blocks"):
        TM.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="whole blocks"):
        TM.forward(cfg, model[1], {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
    with pytest.raises(ValueError, match="whole blocks"):
        TM.init_cache(cfg, 1, 8, device="cpu")


def test_server_mixed_lengths_match_full_forward(model):
    """At a capacity with no drops, prompts of 3 and 9 tokens in one batch
    and 6 greedy tokens each: every lane equals its own full-forward
    rollout."""
    _, params, _, _ = model
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), capacity_factor=100.0)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)] for n in (3, 9)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = tlaunch.Server(cfg, params, max_len=32, slots=2).generate(prompts, max_new=6)
    for p, row in zip(prompts, got):
        toks = list(p)
        with torch.no_grad():
            for _ in range(6):
                toks.append(int(TM.forward(cfg, params, {"tokens": torch.tensor([toks])})
                                [0, -1].argmax()))
        assert row == toks[len(p):]


def test_train_cli_in_process(tmp_path, capsys):
    """``--arch jamba_1_5_large_398b --layers 8 --device cpu`` trains 3
    GaLore steps in process with an aux_loss on each line; ``--layers 12``
    raises."""
    args = ["--arch", ARCH, "--steps", "3", "--seq", "16", "--batch", "2", "--galore-rank", "16",
            "--galore-fused", "--device", "cpu", "--log-every", "1"]
    ttrain.main(args + ["--layers", "8", "--ckpt-dir", str(tmp_path / "a")])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[train] step")]
    assert len(lines) == 3 and all("aux_loss" in ln for ln in lines)
    with pytest.raises(ValueError, match="whole blocks"):
        ttrain.main(args + ["--layers", "12", "--ckpt-dir", str(tmp_path / "b")])
