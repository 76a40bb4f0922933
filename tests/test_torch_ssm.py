"""The SSM family (Mamba-2's SSD layer, ``mamba2_130m``) in the port against
the JAX package, on the smoke config (f32: 2 layers, d_model 64, 8 heads of
16, state 16, chunk 8), from the port's weights handed across as numpy.

1. Logits and loss within 1e-5·max at S = 13, no multiple of the chunk, so
   the padded tail of the scan is covered; each layer's gradients (of x and
   of every leaf) within 1e-5·max on shared inputs. One layer over a chunk
   of 256 steps equals the one-token recurrence, where the reference's
   chunked scan does not (ROADMAP C.19); in bf16 decode equals the full
   forward, where the reference's drifts (C.21).
2. Prefill then decode equals the full forward at S = 2, 3 and 13; at 3 and
   13 the port's prefill and decode logits equal JAX's own. At S = 2 < k − 1
   the reference's first decode step raises (ROADMAP C.18); the port's
   equals the full forward.
3. A JAX GaLore-AdamW run checkpoints at step 1: the checkpoint restores in
   the port bit for bit and the port's state after its next step restores in
   JAX bit for bit; that fused step lands within 2e-5 of JAX's on every
   leaf, the SSD projections among them (in_z / in_x left, out_proj right).
4. A 20-step GaLore trajectory within 5e-2 of JAX's on loss.
5. The ``Server``: on prompts of one length its greedy tokens equal JAX's
   Server's; a batch of 3- and 9-token prompts equals each prompt's own
   full-forward rollout, where the reference's loop decodes the short
   prompt from its padding (ROADMAP C.13).
6. The train launcher's ``main`` in process with ``--arch mamba2_130m``.
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
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticC4 as JSyntheticC4  # noqa: E402
from repro.distributed import step as jstep  # noqa: E402
from repro.launch import serve as jlaunch  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.bridge import cache_to_numpy, params_to_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.subspace import SubspaceManager  # noqa: E402
from repro_torch.distributed import step as tstep  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.utils import tree_leaves_with_path, tree_map  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ARCH = "mamba2_130m"
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


@pytest.fixture(scope="module")
def model():
    """(port cfg, port params, JAX cfg, the same params as JAX arrays)."""
    cfg = get_config(ARCH, smoke=True)
    params = TM.init_params(cfg, seed=0, device="cpu")
    return cfg, params, jax_get_config(ARCH, smoke=True), tree_map(jnp.asarray,
                                                                     params_to_numpy(params))


# ---------------------------------------------------------------------------
# 1. logits, loss, gradients
# ---------------------------------------------------------------------------


def test_ssm_logits_and_loss_match_jax(model):
    """Logits and loss within 1e-5·max of JAX's at S = 13; the port's
    gradient tree has the reference's leaves (names, shapes, dtypes), each
    finite; A_log, D and dt_bias stay f32."""
    cfg, params, jcfg, jparams = model
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
    assert float(metrics["aux_loss"]) == 0.0
    leaves = tree_leaves_with_path(params)
    grads = torch.autograd.grad(total, [p for _, p in leaves])
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): x.shape
            for path, x in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert sorted(want) == [path for path, _ in leaves]
    for (path, p), g in zip(leaves, grads):
        assert g.dtype == p.dtype and tuple(g.shape) == want[path], path
        assert torch.isfinite(g).all(), path
    for name in ("A_log", "D", "dt_bias"):
        assert params["blocks"]["mix"][name].dtype == torch.float32


@functools.lru_cache(maxsize=None)
def _jax_layer_grad():
    """JAX's pre-norm residual SSD layer (model._apply_ssm_stack's body) with
    the loss sum(y·w): jitted value_and_grad (p, x, w) -> ((loss, y), (dp,
    dx)), compiled once for both layers."""
    jcfg = jax_get_config(ARCH, smoke=True)

    def loss(p, x, w):
        y = x + jssm.apply_ssm(jcfg, p["mix"], jlayers.apply_norm(jcfg, p["ln"], x))[0]
        return jnp.sum(y * w), y

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


@pytest.mark.parametrize("layer", [0, 1])
def test_layer_grads_match_jax(model, layer):
    """Each layer's pre-norm residual SSD block on the same input x (B = 2,
    S = 13: a padded second chunk) and the same output cotangent: the output
    and the gradients of x and of every leaf within 1e-5·max of JAX's.

    Held per layer, not through the whole model: this random model's f32
    gradients are determined by rounding only to several times 1e-5·max
    (JAX's own differ from a float64 evaluation of the port by up to 15.5×
    1e-5·max on conv_C_w; tests/ssm_conditioning.py), so only a layer's
    gradients on shared inputs are held to that tolerance."""
    cfg, params, _, _ = model
    lp = tree_map(lambda t: t.detach()[layer].clone().requires_grad_(True), params["blocks"])
    rng = np.random.default_rng(20 + layer)
    x = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)

    (_, jy), (jgp, jgx) = _jax_layer_grad()(tree_map(jnp.asarray, params_to_numpy(lp)), x, w)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = xt + tssm.apply_ssm(cfg, lp["mix"], TL.apply_norm(cfg, lp["ln"], xt))
    _close(y, jy, "y")
    leaves = tree_leaves_with_path(lp)
    gs = torch.autograd.grad((y * torch.from_numpy(w)).sum(), [xt] + [t for _, t in leaves])
    _close(gs[0], jgx, "grad x")
    jflat = _jflat(jgp)
    assert sorted(jflat) == [path for path, _ in leaves]
    for (path, _), g in zip(leaves, gs[1:]):
        _close(g, jflat[path], f"grad {path}")


def test_long_chunk_matches_the_recurrence(model):
    """One SSD layer over a single chunk of 256 steps (the full config's
    chunk; 32 heads, so A reaches −32): the chunked scan equals the one-token
    recurrence run step by step within 1e-5·max. The reference's chunked scan
    does not (ROADMAP C.19): it takes the segment decays as differences of
    two f32 running sums that reach −10³, and loses their low bits, while its
    own recurrence equals the port's."""
    cfg = dataclasses.replace(model[0], ssm_chunk=256, ssm_head_dim=4)
    jcfg = dataclasses.replace(model[2], ssm_chunk=256, ssm_head_dim=4)
    p = tssm.init_ssm(torch.Generator().manual_seed(0), cfg, torch.float32)
    jp = {k: jnp.asarray(v) for k, v in params_to_numpy(p).items()}
    x = np.random.default_rng(0).standard_normal((2, 256, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        y = tssm.apply_ssm(cfg, p, torch.from_numpy(x)).numpy()
        cache = tssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
        rec = np.concatenate([tssm.apply_ssm(cfg, p, torch.from_numpy(x[:, t:t + 1]), cache)
                              .numpy() for t in range(256)], axis=1)
    jy = np.asarray(jax.jit(lambda p, x: jssm.apply_ssm(jcfg, p, x)[0])(jp, x))
    jstep = jax.jit(lambda p, x, c: jssm.apply_ssm(jcfg, p, x, c, 0))
    jc, jrec = jssm.init_ssm_cache(jcfg, 2, jnp.float32), []
    for t in range(256):
        out, jc = jstep(jp, x[:, t:t + 1], jc)
        jrec.append(np.asarray(out))
    jrec = np.concatenate(jrec, axis=1)
    _close(jrec, rec, "the reference's recurrence vs the port's")
    _close(y, rec, "chunked vs recurrence")
    assert np.abs(jy - rec).max() > 1e-5 * np.abs(rec).max()  # the reference's lost bits


# ---------------------------------------------------------------------------
# 2. prefill + decode
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_cached_forward():
    """JAX's forward with a cache, jitted once for the module: (params, cache,
    tokens, cache_pos) -> (logits, aux, cache); a decode step's shapes are
    the same at every S, so it compiles once."""
    jcfg = jax_get_config(ARCH, smoke=True)
    return jax.jit(lambda p, c, t, pos: JM.forward(jcfg, p, {"tokens": t}, cache=c,
                                                   cache_pos=pos))


@pytest.mark.parametrize("S", [2, 3, 13])
def test_prefill_decode_matches_full_forward(model, S):
    """Prefill S tokens, then decode 3 teacher-forced tokens: every logit
    within 1e-5·max of the full forward's at its position; at S ≥ k − 1 also
    the JAX prefill's and decode's logits and caches."""
    cfg, params, jcfg, jparams = model
    n = S + 3
    tokens = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, n))
    with torch.no_grad():
        full = TM.forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    cache = TM.init_cache(cfg, 2, n, device="cpu")
    with torch.inference_mode():
        pre, cache = TM.forward_cached(cfg, params, {"tokens": torch.from_numpy(tokens[:, :S])},
                                       cache=cache, cache_pos=0)
        dec = []
        for pos in range(S, n):
            logits, cache = TM.forward_cached(
                cfg, params, {"tokens": torch.from_numpy(tokens[:, pos:pos + 1])},
                cache=cache, cache_pos=pos)
            dec.append(logits[:, 0])
    _close(pre, full[:, :S], "prefill")
    _close(torch.stack(dec, 1), full[:, S:], "decode")
    assert cache["conv_x"].shape == (cfg.n_layers, 2, cfg.ssm_conv - 1, 2 * cfg.d_model)

    jcache = JM.init_cache(jcfg, 2, n)
    jpre, _, jcache = _jax_cached_forward()(jparams, jcache,
                                            jnp.asarray(tokens[:, :S], jnp.int32), 0)
    jdecode = _jax_cached_forward()
    if S < cfg.ssm_conv - 1:  # the reference's short conv history (C.18)
        assert jcache["conv_x"].shape[2] == S
        with pytest.raises(ValueError):
            jdecode(jparams, jcache, jnp.asarray(tokens[:, S:S + 1], jnp.int32), S)
        return
    _close(pre, jpre, "prefill vs JAX")
    jdec = []
    for pos in range(S, n):
        logits, _, jcache = jdecode(jparams, jcache, jnp.asarray(tokens[:, pos:pos + 1],
                                                                 jnp.int32), pos)
        jdec.append(np.asarray(logits)[:, 0])
    _close(torch.stack(dec, 1), np.stack(jdec, 1), "decode vs JAX")
    got = cache_to_numpy(cache)
    for k, want in _jflat(jcache).items():
        _close(got[k], want, f"cache {k}")


def test_bf16_decode_equals_the_full_forward(model):
    """In bf16, a 7-token prefill and 6 decode steps give the full forward's
    logits (within 1e-5·max; here bit for bit): the port's decode takes its
    conv output from the scan's own conv, summed in f32 and rounded once.
    The reference's decode rounds its conv apart from its scan's, and the
    state carries the difference on: its logits drift from its own full
    forward's by more than 1e-3·max (ROADMAP C.21)."""
    cfg = dataclasses.replace(model[0], dtype="bfloat16")
    jcfg = dataclasses.replace(model[2], dtype="bfloat16")
    params = TM.init_params(cfg, seed=0, device="cpu")  # A_log, D, dt_bias stay f32
    jparams = tree_map(lambda a, t: jnp.asarray(a).astype(jnp.bfloat16)
                       if t.dtype == torch.bfloat16 else jnp.asarray(a),
                       params_to_numpy(params), params)
    S, n = 7, 13
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, n))
    with torch.no_grad():
        full = TM.forward(cfg, params, {"tokens": torch.from_numpy(tokens)}).float()
    cache = TM.init_cache(cfg, 2, n, device="cpu")
    with torch.inference_mode():
        TM.forward_cached(cfg, params, {"tokens": torch.from_numpy(tokens[:, :S])},
                          cache=cache, cache_pos=0)
        dec = torch.stack([TM.forward_cached(cfg, params, {"tokens": torch.from_numpy(
            tokens[:, q:q + 1])}, cache=cache, cache_pos=q)[0][:, 0] for q in range(S, n)], 1)
    _close(dec.float(), full[:, S:], "decode vs full forward, bf16")
    jf = jax.jit(lambda p, c, t, pos: JM.forward(jcfg, p, {"tokens": t}, cache=c, cache_pos=pos))
    jfull = np.asarray(jf(jparams, None, jnp.asarray(tokens, jnp.int32), None)[0], np.float32)
    _, _, jc = jf(jparams, JM.init_cache(jcfg, 2, n), jnp.asarray(tokens[:, :S], jnp.int32), 0)
    jdec = []
    for q in range(S, n):
        logits, _, jc = jf(jparams, jc, jnp.asarray(tokens[:, q:q + 1], jnp.int32), q)
        jdec.append(np.asarray(logits, np.float32)[:, 0])
    drift = np.abs(np.stack(jdec, 1) - jfull[:, S:]).max() / np.abs(jfull).max()
    assert drift > 1e-3, drift  # the reference's decode rounds apart from its scan


# ---------------------------------------------------------------------------
# 3–4. GaLore: checkpoint both ways, one update, the trajectory
# ---------------------------------------------------------------------------


class _Bridged:
    """The JAX pipeline's batches as CPU tensors."""

    def __init__(self, jdata):
        self.jdata = jdata

    def batch(self, step):
        return {k: torch.from_numpy(np.asarray(v).astype(np.int64 if k != "loss_mask"
                                                           else np.float32))
                for k, v in self.jdata.batch(step).items()}


def _train_configs():
    common = dict(optimizer="adamw", weight_decay=0.01, total_steps=STEPS, warmup_steps=2)
    return (JTrainConfig(galore=JGaLoreConfig(**_G), **common),
            TrainConfig(galore=GaLoreConfig(**_G), galore_fused_adam=True, **common))


@pytest.fixture(scope="module")
def jax_run(model, tmp_path_factory):
    """One JAX GaLore run from the port's initial weights: a checkpoint at
    step 1, the params and loss of step 2, and the 20 steps' losses."""
    cfg, p0, jcfg, jp = model
    jdata = JSyntheticC4(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                     batch_per_host=BATCH))
    jtc, _ = _train_configs()
    step_fn, jopt = jstep.make_train_step(jcfg, jtc)
    step_fn = jax.jit(step_fn)
    js = jax.jit(jopt.init)(jp)
    init = {"params": jp, "opt_state": js}
    root = tmp_path_factory.mktemp("jax_ssm")
    out = dict(root=root, init=init, data=jdata, p0=p0, losses=[])
    for s in range(STEPS):
        jp, js, metrics = step_fn(jp, js, jdata.batch(s))
        out["losses"].append(float(metrics["loss"]))
        if s == 1:
            saved = {"params": jp, "opt_state": js}
            JCheckpointManager(str(root), async_save=False).save(1, saved, block=True)
            out["saved"] = _jflat(saved)
        if s == 2:
            out["next_params"], out["next_loss"] = _jflat(jp), float(metrics["loss"])
    return out


def _restore(root):
    cfg = get_config(ARCH, smoke=True)
    _, tc = _train_configs()
    step_fn, opt = tstep.make_train_step(cfg, tc)
    params = TM.init_params(cfg, seed=0, device="cpu")
    target = {"params": params, "opt_state": opt.init(params)}
    return CheckpointManager(str(root), async_save=False).restore(1, target), step_fn, tc


def test_galore_update_and_checkpoint_both_ways(jax_run, tmp_path):
    """The JAX checkpoint restores in the port bit for bit; from it the
    port's fused GaLore step on JAX's step-2 batch is within 2e-5 of JAX's on
    the loss and every parameter (in_z / in_x project left, out_proj right,
    in_B / in_C / in_dt and the conv and norm leaves pass through); the
    port's state after that step restores in JAX bit for bit."""
    restored, step_fn, tc = _restore(jax_run["root"])
    _bitwise(_flat(restored), jax_run["saved"])
    plans = dict(tree_leaves_with_path(SubspaceManager(tc.galore).plans(restored["params"])))
    for leaf, side in (("in_z", "left"), ("in_x", "left"), ("out_proj", "right")):
        plan = plans[f"blocks.mix.{leaf}"]
        assert plan.galore and plan.side == side, leaf
    for leaf in ("in_B", "in_C", "in_dt", "conv_x_w", "A_log", "norm_scale"):
        assert not plans[f"blocks.mix.{leaf}"].galore, leaf
    params, opt_state, metrics = step_fn(restored["params"], restored["opt_state"],
                                         _Bridged(jax_run["data"]).batch(2))
    assert abs(float(metrics["loss"]) - jax_run["next_loss"]) <= 2e-5
    got = _flat(params)
    for k, want in jax_run["next_params"].items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=2e-5, err_msg=k)
    port_tree = {"params": params, "opt_state": opt_state}
    CheckpointManager(str(tmp_path), async_save=False).save(2, port_tree, block=True)
    back = JCheckpointManager(str(tmp_path), async_save=False).restore(2, jax_run["init"])
    _bitwise(_jflat(back), _flat(port_tree))


def test_galore_trajectory_matches_jax(jax_run, tmp_path):
    """The port's fused GaLore steps (rank 16, T 10) on the JAX pipeline's
    batches: per-step losses within 5e-2 of JAX's composable run, falling."""
    _, tc = _train_configs()
    got = []
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), jax_run["p0"])
    train_loop(RunConfig(steps=STEPS, batch_per_host=BATCH, seq_len=SEQ, log_every=STEPS,
                         ckpt_dir=str(tmp_path), device="cpu"),
               tc, cfg=get_config(ARCH, smoke=True), params=params,
               data=_Bridged(jax_run["data"]), on_step=lambda s, m: got.append(float(m["loss"])))
    np.testing.assert_allclose(got, jax_run["losses"], rtol=0, atol=5e-2)
    assert got[-1] < got[0]


# ---------------------------------------------------------------------------
# 5–6. the Server and the train launcher
# ---------------------------------------------------------------------------


def _rollout(cfg, params, prompt, n):
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = TM.forward(cfg, params, {"tokens": torch.tensor([toks])})
            toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


@pytest.fixture(scope="module")
def servers(model):
    """The port's Server and JAX's on the same weights; JAX's, built once,
    compiles its decode step once for both tests."""
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
    with pytest.raises(ValueError, match="max_len"):
        server.generate([list(range(30))], max_new=6)


def test_train_cli_in_process(tmp_path, capsys):
    """``--arch mamba2_130m --device cpu`` trains 4 GaLore steps in process,
    a loss line a step."""
    ttrain.main(["--arch", ARCH, "--steps", "4", "--seq", "32", "--batch", "2",
                 "--galore-rank", "16", "--galore-fused", "--device", "cpu", "--log-every", "1",
                 "--ckpt-dir", str(tmp_path)])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[train] step")]
    assert len(lines) == 4


def test_serve_cli_refuses_like_the_reference():
    """The serve CLI builds an Engine over a paged cache, which an SSM model
    has none of: it raises NotImplementedError, as the reference's CLI does
    (init_paged_cache); the Server is the entry point that serves it."""
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        tlaunch.main(["--arch", ARCH, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        JM.init_paged_cache(jax_get_config(ARCH, smoke=True), 4, 4)
