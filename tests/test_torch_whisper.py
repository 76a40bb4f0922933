"""The encoder-decoder family (``whisper_small``: LayerNorm, the tanh GELU
MLP, the bidirectional encoder, the cross-attention decoder and its cached
cross K/V) in the port against the JAX package, on the smoke config (f32: 2
encoder and 2 decoder layers, d_model 64, 4 heads of 16, 16 frames), from
the port's weights handed across as numpy.

The init's ``dec_pos`` is zeros, and with zero frames every encoder position
is the same, so a position off by one or a cross-attention reading the
wrong K/V would not show: every check of the model, caching and decode
draws dec_pos (0.02·N(0, 1)) and frames (0.1·N(0, 1)) with numpy.

1. LayerNorm and the GELU MLP within 1e-6·max of the reference's; the
   encoder stack, the cross K/V and one cross-decoder layer within 1e-5·max;
   logits, loss and every gradient at the model within 1e-5·max.
2. Prefill then decode equals the full forward and JAX's cached steps at
   prompt lengths 1, 5 and 11; the cross K/V are written into the caller's
   cache in place, and JAX's cache crosses the bridge both ways. Past the
   8192 learned positions the port raises where the reference clamps
   (ROADMAP C.22).
3. A JAX GaLore-AdamW run on frame-carrying batches checkpoints at step 1:
   the checkpoint restores in the port bit for bit and the port's state
   after its next step in JAX; that fused step lands within 2e-5 of JAX's;
   a 20-step trajectory within 5e-2 on loss.
4. The ``Server`` (zero frames, as the reference's): tokens equal JAX's
   Server's on prompts of one length and each prompt's full-forward rollout
   on mixed lengths, where the reference's loop decodes the short prompt
   from its padding (ROADMAP C.13).
5. The CLIs: the train launcher without a frames source raises KeyError
   naming enc_frames before step 0, as the reference's does at its first
   step; the serve CLI refuses the family (no paged cache), as the
   reference's.
"""
import dataclasses
import functools
import sys
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
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticC4 as JSyntheticC4  # noqa: E402
from repro.distributed import step as jstep  # noqa: E402
from repro.launch import serve as jlaunch  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import stacks as jstacks  # noqa: E402
from repro_torch.bridge import cache_from_numpy, cache_to_numpy, params_to_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.subspace import SubspaceManager  # noqa: E402
from repro_torch.distributed import step as tstep  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import stacks as tstacks  # noqa: E402
from repro_torch.utils import tree_leaves_with_path, tree_map  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ARCH = "whisper_small"
STEPS, BATCH, SEQ = 20, 4, 32
_G = dict(rank=16, update_freq=10, scale=0.25)


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


def _frames(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((batch, cfg.enc_seq, cfg.d_model))).astype(np.float32)


@pytest.fixture(scope="module")
def model():
    """(port cfg, port params with dec_pos drawn, JAX cfg, the same params as
    JAX arrays)."""
    cfg = get_config(ARCH, smoke=True)
    params = TM.init_params(cfg, seed=0, device="cpu")
    assert not params["dec_pos"].any()  # zeros at init, as the reference's
    pos = 0.02 * np.random.default_rng(7).standard_normal(tuple(params["dec_pos"].shape))
    with torch.no_grad():
        params["dec_pos"].copy_(torch.from_numpy(pos.astype(np.float32)))
    return cfg, params, jax_get_config(ARCH, smoke=True), tree_map(jnp.asarray,
                                                                     params_to_numpy(params))


# ---------------------------------------------------------------------------
# 1. layers, stacks, the model
# ---------------------------------------------------------------------------


def test_layernorm_and_gelu_mlp_match_jax(model):
    """LayerNorm ({"scale", "bias"}) and the GELU MLP ({"up", "down"}; the
    tanh form, jax.nn.gelu's default) within 1e-6·max of the reference's on
    random inputs and parameters; the exact erf GELU would miss even the
    model's 1e-5·max."""
    cfg, params, jcfg, _ = model
    rng = np.random.default_rng(3)
    x = (3.0 * rng.standard_normal((2, 9, cfg.d_model)) + 1.0).astype(np.float32)
    norm = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32),
            "bias": rng.standard_normal(cfg.d_model).astype(np.float32)}
    assert sorted(params["final_norm"]) == ["bias", "scale"]
    got = TL.apply_norm(cfg, {k: torch.from_numpy(v) for k, v in norm.items()},
                        torch.from_numpy(x))
    _close(got, jlayers.apply_norm(jcfg, tree_map(jnp.asarray, norm), jnp.asarray(x)),
           "layernorm", tol=1e-6)
    assert sorted(params["blocks"]["ffn"]) == ["down", "up"]
    mlp = {"up": rng.standard_normal((cfg.d_model, cfg.d_ff)).astype(np.float32) * 0.3,
           "down": rng.standard_normal((cfg.d_ff, cfg.d_model)).astype(np.float32) * 0.1}
    got = TL.apply_mlp(cfg, {k: torch.from_numpy(v) for k, v in mlp.items()}, torch.from_numpy(x))
    want = np.asarray(jlayers.apply_mlp(jcfg, tree_map(jnp.asarray, mlp), jnp.asarray(x)))
    _close(got, want, "gelu mlp", tol=1e-6)
    xt, up = torch.from_numpy(x), torch.from_numpy(mlp["up"])
    erf = torch.nn.functional.gelu(xt @ up) @ torch.from_numpy(mlp["down"])
    assert np.abs(erf.numpy() - want).max() > 1e-5 * np.abs(want).max()


def test_encoder_and_cross_decoder_layer_match_jax(model):
    """The encoder stack on drawn frames, every layer's cross K/V from its
    output, and one cross-decoder layer on a drawn x against those K/V, each
    within 1e-5·max of the reference's."""
    cfg, params, jcfg, jparams = model
    frames = _frames(cfg, 2, 11)
    with torch.no_grad():
        enc = tstacks.apply_encoder_stack(cfg, params["encoder"], torch.from_numpy(frames))
        kv = tstacks.compute_enc_kv(cfg, params["blocks"], enc)
    jenc = jax.jit(lambda p, f: jstacks.apply_encoder_stack(jcfg, p, f))(jparams["encoder"],
                                                                      frames)
    _close(enc, jenc, "encoder")
    jkv = jax.jit(lambda p, e: jstacks.compute_enc_kv(jcfg, p, e))(jparams["blocks"], jenc)
    _close(kv[0], jkv[0], "cross k")
    _close(kv[1], jkv[1], "cross v")

    one = dataclasses.replace(cfg, n_layers=1)
    jone = dataclasses.replace(jcfg, n_layers=1)
    x = np.random.default_rng(12).standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    layer = tree_map(lambda t: t.detach()[1:2], params["blocks"])
    with torch.no_grad():
        got = tstacks.apply_crossdecoder_stack(one, layer, torch.from_numpy(x),
                                               (kv[0][1:2], kv[1][1:2]))
    want = jax.jit(lambda p, x, k, v: jstacks.apply_crossdecoder_stack(jone, p, x, (k, v))[0])(
        tree_map(lambda a: a[1:2], jparams["blocks"]), x, jkv[0][1:2], jkv[1][1:2])
    _close(got, want, "cross-decoder layer")


def test_logits_loss_and_every_gradient_match_jax(model):
    """Logits, loss and the gradient of every leaf (the encoder's, the cross
    and self attention's, the norms' biases, dec_pos, the embedding) at the
    model within 1e-5·max of JAX's, on drawn frames and a loss mask."""
    cfg, params, jcfg, jparams = model
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 11))
    mask = (rng.random((2, 11)) > 0.1).astype(np.float32)
    frames = _frames(cfg, 2, 2)
    jb = {"tokens": jnp.asarray(tokens, jnp.int32), "loss_mask": jnp.asarray(mask),
          "enc_frames": jnp.asarray(frames)}

    def f(p):
        (total, metrics), grads = jax.value_and_grad(
            lambda p: JM.loss_fn(jcfg, p, jb), has_aux=True)(p)
        return total, metrics, grads, JM.forward(jcfg, p, jb)[0]

    jtotal, jmetrics, jgrads, jlogits = jax.jit(f)(jparams)
    tb = {"tokens": torch.from_numpy(tokens), "loss_mask": torch.from_numpy(mask),
          "enc_frames": torch.from_numpy(frames)}
    total, metrics = TM.loss_fn(cfg, params, tb)
    with torch.no_grad():
        _close(TM.forward(cfg, params, tb), jlogits, "logits")
    _close(total, jtotal, "total")
    _close(metrics["loss"], jmetrics["loss"], "loss")
    assert float(metrics["aux_loss"]) == 0.0
    leaves = tree_leaves_with_path(params)
    grads = torch.autograd.grad(total, [p for _, p in leaves])
    jflat = _jflat(jgrads)
    assert sorted(jflat) == [path for path, _ in leaves]
    for (path, _), g in zip(leaves, grads):
        _close(g, jflat[path], f"grad {path}")


# ---------------------------------------------------------------------------
# 2. prefill + decode, the cache, the dec_pos window
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_cached_forward():
    """JAX's forward with a cache and the batch, jitted once for the module."""
    jcfg = jax_get_config(ARCH, smoke=True)
    return jax.jit(lambda p, c, b, pos: JM.forward(jcfg, p, b, cache=c, cache_pos=pos))


MAX_LEN = 14  # one cache length for every S: JAX compiles its decode step once


@pytest.mark.parametrize("S", [1, 5, 11])
def test_prefill_decode_matches_full_forward(model, S):
    """Prefill S tokens with drawn frames through make_prefill_step, then 3
    teacher-forced decode steps through make_decode_step (tokens only): the
    prefill's last logits and every decode step's within 1e-5·max of the
    full forward's at their positions and of JAX's cached steps. The prefill
    writes the encoder's cross K/V into the caller's own cache tensors; the
    port's cache equals JAX's (bridge.cache_to_numpy), and JAX's cache
    brought in by cache_from_numpy decodes the same logits."""
    cfg, params, jcfg, jparams = model
    n = S + 3
    tokens = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, n))
    frames = _frames(cfg, 2, 100 + S)
    with torch.no_grad():
        full = TM.forward(cfg, params, {"tokens": torch.from_numpy(tokens),
                                        "enc_frames": torch.from_numpy(frames)})
    prefill, decode = tstep.make_prefill_step(cfg), tstep.make_decode_step(cfg, with_logits=True)
    cache = TM.init_cache(cfg, 2, MAX_LEN, device="cpu")
    cross_k = cache["cross_k"]
    last, cache = prefill(params, cache, {"tokens": torch.from_numpy(tokens[:, :S]),
                                          "enc_frames": torch.from_numpy(frames)})
    assert cache["cross_k"] is cross_k and cross_k.abs().max() > 0  # written in place
    dec = []
    for pos in range(S, n):
        _, logits, cache = decode(params, cache, torch.from_numpy(tokens[:, pos:pos + 1]), pos)
        dec.append(logits)
    _close(last, full[:, S - 1], "prefill")
    _close(torch.stack(dec, 1), full[:, S:], "decode")

    jf = _jax_cached_forward()
    jb = {"tokens": jnp.asarray(tokens[:, :S], jnp.int32), "enc_frames": jnp.asarray(frames)}
    jpre, _, jcache = jf(jparams, JM.init_cache(jcfg, 2, MAX_LEN), jb, 0)
    _close(last, np.asarray(jpre)[:, -1], "prefill vs JAX")
    ported = cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    jdec, again = [], []
    for pos in range(S, n):
        tok = tokens[:, pos:pos + 1]
        logits, _, jcache = jf(jparams, jcache, {"tokens": jnp.asarray(tok, jnp.int32)}, pos)
        jdec.append(np.asarray(logits)[:, 0])
        _, logits, ported = decode(params, ported, torch.from_numpy(tok), pos)
        again.append(logits)
    _close(torch.stack(dec, 1), np.stack(jdec, 1), "decode vs JAX")
    _close(torch.stack(again, 1), np.stack(jdec, 1), "decode from JAX's cache")
    got = dict(tree_leaves_with_path(cache_to_numpy(cache)))
    assert sorted(got) == sorted(_jflat(jcache))
    for k, want in _jflat(jcache).items():
        _close(got[k], want, f"cache {k}")


def test_dec_pos_window_raises_where_the_reference_clamps(model):
    """A 5-token prefill at cache_pos 8190 needs positions 8190 … 8194 of
    the 8192 learned ones: the reference's dynamic_slice clamps the start to
    8187, and its logits equal its own at cache_pos 8187 (ROADMAP C.22); the
    port raises ValueError there, and at 8187 gives the reference's
    logits."""
    cfg, params, jcfg, jparams = model
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 5))
    frames = _frames(cfg, 2, 4)
    jf = _jax_cached_forward()
    jb = {"tokens": jnp.asarray(tokens, jnp.int32), "enc_frames": jnp.asarray(frames)}
    clamped = np.asarray(jf(jparams, JM.init_cache(jcfg, 2, 5), jb, 8190)[0])
    edge = np.asarray(jf(jparams, JM.init_cache(jcfg, 2, 5), jb, 8187)[0])
    np.testing.assert_array_equal(clamped, edge)
    tb = {"tokens": torch.from_numpy(tokens), "enc_frames": torch.from_numpy(frames)}
    with torch.inference_mode():
        got, _ = TM.forward_cached(cfg, params, tb, cache=TM.init_cache(cfg, 2, 5, device="cpu"),
                                   cache_pos=8187)
        _close(got, edge, "logits at the last whole window")
        with pytest.raises(ValueError, match="dec_pos"):
            TM.forward_cached(cfg, params, tb, cache=TM.init_cache(cfg, 2, 5, device="cpu"),
                              cache_pos=8190)


# ---------------------------------------------------------------------------
# 3. GaLore: checkpoint both ways, one update, the trajectory
# ---------------------------------------------------------------------------


class _Frames:
    """The JAX pipeline's batches with frames drawn from the step's seed; as
    JAX arrays (`jax` True) or as CPU tensors."""

    def __init__(self, jdata, cfg, jax_side):
        self.jdata, self.cfg, self.jax_side = jdata, cfg, jax_side

    def batch(self, step):
        b = dict(self.jdata.batch(step))
        frames = _frames(self.cfg, BATCH, 1000 + step)
        if self.jax_side:
            return dict(b, enc_frames=jnp.asarray(frames))
        out = {k: torch.from_numpy(np.asarray(v).astype(np.int64 if k != "loss_mask"
                                                        else np.float32))
               for k, v in b.items()}
        return dict(out, enc_frames=torch.from_numpy(frames))


def _train_configs():
    common = dict(optimizer="adamw", weight_decay=0.01, total_steps=STEPS, warmup_steps=2)
    return (JTrainConfig(galore=JGaLoreConfig(**_G), **common),
            TrainConfig(galore=GaLoreConfig(**_G), galore_fused_adam=True, **common))


@pytest.fixture(scope="module")
def jax_run(model, tmp_path_factory):
    """One JAX GaLore run from the port's weights on frame-carrying batches:
    a checkpoint at step 1, the params and loss of step 2, and the 20 steps'
    losses."""
    cfg, p0, jcfg, jp = model
    jdata = JSyntheticC4(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                     batch_per_host=BATCH))
    jtc, _ = _train_configs()
    step_fn, jopt = jstep.make_train_step(jcfg, jtc)
    step_fn = jax.jit(step_fn)
    js = jax.jit(jopt.init)(jp)
    init = {"params": jp, "opt_state": js}
    root = tmp_path_factory.mktemp("jax_whisper")
    data = _Frames(jdata, cfg, jax_side=True)
    out = dict(root=root, init=init, data=_Frames(jdata, cfg, jax_side=False), p0=p0, losses=[])
    for s in range(STEPS):
        jp, js, metrics = step_fn(jp, js, data.batch(s))
        out["losses"].append(float(metrics["loss"]))
        if s == 1:
            saved = {"params": jp, "opt_state": js}
            JCheckpointManager(str(root), async_save=False).save(1, saved, block=True)
            out["saved"] = _jflat(saved)
        if s == 2:
            out["next_params"], out["next_loss"] = _jflat(jp), float(metrics["loss"])
    return out


def test_galore_update_and_checkpoint_both_ways(jax_run, tmp_path):
    """The JAX checkpoint restores in the port bit for bit; from it the
    port's fused GaLore step on JAX's step-2 batch is within 2e-5 of JAX's on
    the loss and every parameter (every attention projection and ffn.up
    project left, ffn.down right; the norms, dec_pos and the embedding pass
    through); the port's state after that step restores in JAX bit for bit."""
    cfg = get_config(ARCH, smoke=True)
    _, tc = _train_configs()
    step_fn, opt = tstep.make_train_step(cfg, tc)
    params = TM.init_params(cfg, seed=0, device="cpu")
    target = {"params": params, "opt_state": opt.init(params)}
    restored = CheckpointManager(str(jax_run["root"]), async_save=False).restore(1, target)
    _bitwise(_flat(restored), jax_run["saved"])
    plans = dict(tree_leaves_with_path(SubspaceManager(tc.galore).plans(restored["params"])))
    sides = {path: plan.side for path, plan in plans.items() if plan.galore}
    assert sides == {**{f"{stack}.{w}": "left" for stack in ("encoder.attn", "blocks.self_attn",
                                                              "blocks.cross_attn")
                        for w in ("wq", "wk", "wv", "wo")},
                     "encoder.ffn.up": "left", "blocks.ffn.up": "left",
                     "encoder.ffn.down": "right", "blocks.ffn.down": "right"}
    params, opt_state, metrics = step_fn(restored["params"], restored["opt_state"],
                                         jax_run["data"].batch(2))
    assert abs(float(metrics["loss"]) - jax_run["next_loss"]) <= 2e-5
    got = _flat(params)
    for k, want in jax_run["next_params"].items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=2e-5, err_msg=k)
    port_tree = {"params": params, "opt_state": opt_state}
    CheckpointManager(str(tmp_path), async_save=False).save(2, port_tree, block=True)
    back = JCheckpointManager(str(tmp_path), async_save=False).restore(2, jax_run["init"])
    _bitwise(_jflat(back), _flat(port_tree))


def test_galore_trajectory_matches_jax(jax_run, tmp_path):
    """The port's fused GaLore steps (rank 16, T 10) through train_loop's
    data hook on the same frame-carrying batches: per-step losses within
    5e-2 of JAX's composable run, falling."""
    _, tc = _train_configs()
    got = []
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), jax_run["p0"])
    train_loop(RunConfig(steps=STEPS, batch_per_host=BATCH, seq_len=SEQ, log_every=STEPS,
                         ckpt_dir=str(tmp_path), device="cpu"),
               tc, cfg=get_config(ARCH, smoke=True), params=params, data=jax_run["data"],
               on_step=lambda s, m: got.append(float(m["loss"])))
    np.testing.assert_allclose(got, jax_run["losses"], rtol=0, atol=5e-2)
    assert got[-1] < got[0]


# ---------------------------------------------------------------------------
# 4–5. the Server and the CLIs
# ---------------------------------------------------------------------------


def _rollout(cfg, params, prompt, n):
    """Greedy tokens from the full forward on zero frames, the Server's."""
    toks = list(prompt)
    frames = torch.zeros((1, cfg.enc_seq, cfg.d_model))
    with torch.no_grad():
        for _ in range(n):
            logits = TM.forward(cfg, params, {"tokens": torch.tensor([toks]),
                                              "enc_frames": frames})
            toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


@pytest.fixture(scope="module")
def servers(model):
    """The port's Server and JAX's on the same weights (dec_pos drawn)."""
    cfg, params, jcfg, jparams = model
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return (tlaunch.Server(cfg, params, max_len=32, slots=2),
                jlaunch.Server(jcfg, jparams, max_len=32, slots=2))


def test_server_matches_jax_and_full_forward(model, servers):
    """Two prompts of 5 tokens, 6 greedy tokens each: the port's Server gives
    JAX's Server's tokens and each prompt's full-forward rollout."""
    cfg, params, _, _ = model
    server, jserver = servers
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 5)] for _ in range(2)]
    got = server.generate(prompts, max_new=6)
    assert got == [[int(t) for t in row] for row in jserver.generate(prompts, max_new=6)]
    assert got == [_rollout(cfg, params, p, 6) for p in prompts]


def test_server_mixed_lengths_match_full_forward(model, servers):
    """Prompts of 3 and 9 tokens in one batch, 6 greedy tokens: each equals
    its own full-forward rollout. The reference's loop right-pads the short
    prompt and decodes it from its padding (ROADMAP C.13), so its short
    lane differs."""
    cfg, params, _, _ = model
    server, jserver = servers
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)] for n in (3, 9)]
    got = server.generate(prompts, max_new=6)
    want = [_rollout(cfg, params, p, 6) for p in prompts]
    assert got == want
    jgot = [[int(t) for t in row] for row in jserver.generate(prompts, max_new=6)]
    assert jgot[0] != want[0]


def test_train_cli_without_frames_fails_before_step_0(model, tmp_path, capsys, monkeypatch):
    """``--arch whisper_small`` has no frames source: the port's launcher
    raises KeyError naming enc_frames before it takes a step; the
    reference's raises KeyError('enc_frames') at its first step (its init
    handed the smoke weights: JAX's eager init is slow here)."""
    with pytest.raises(KeyError, match="enc_frames"):
        ttrain.main(["--arch", ARCH, "--steps", "2", "--seq", "32", "--batch", "2",
                     "--galore-rank", "16", "--galore-fused", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path / "port")])
    assert "[train] step" not in capsys.readouterr().out
    jparams = model[3]
    monkeypatch.setattr(JM, "init_params", lambda cfg, key: jparams)
    monkeypatch.setattr(sys, "argv", ["train", "--arch", ARCH, "--steps", "2", "--seq", "32",
                                      "--batch", "2", "--ckpt-dir", str(tmp_path / "jax")])
    with pytest.raises(KeyError, match="enc_frames"):
        jtrain.main()


def test_serve_cli_refuses_like_the_reference():
    """The serve CLI builds an Engine over a paged cache, which the
    encoder-decoder has none of: NotImplementedError, as the reference's
    (init_paged_cache); the Server is the entry point that serves it."""
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        tlaunch.main(["--arch", ARCH, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        JM.init_paged_cache(jax_get_config(ARCH, smoke=True), 4, 4)
