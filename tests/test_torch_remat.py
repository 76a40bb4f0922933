"""The reference's activation-checkpointing policies in the port
(models/remat.py: "full", "scores", "names") against its own "none" and
against the JAX package, on the CPU at the smoke configs (f32), from the
port's weights handed across as numpy (bridge.py).

1. For llama_60m, Llama-4 Scout (MoE, an iRoPE group), qwen2_vl (M-RoPE),
   mamba2_130m, Jamba and whisper_small under each policy: loss, aux_loss
   and every gradient leaf bit for bit the port's "none".
2. The same against JAX's loss_fn under the same policy: loss and aux_loss
   at the model within 1e-5·max; every gradient at the model within
   1e-5·max for the attention families; for the SSD families the gradients
   a unit (a mamba layer, a Jamba sub-layer, each run through
   ``stacks.run_units`` under the policy and through the reference's
   ``_remat_wrap``), since their f32 gradients at the model are determined
   only to several times 1e-5·max (ROADMAP C.20).
3. What each policy keeps after the forward, counted by the dry run's
   ``LiveBytes`` on meta tensors at llama_60m smoke (bf16), B × S = 2 × 40,
   one layer's worth (2 layers less 1), against the analytic count:
   "scores" keeps "none"'s less the attention core's tensors (the mask, the
   softmax's exp and row sums, the probabilities) and no (S, T) tensor;
   "names" keeps the unit's input and the five named tensors, the same set
   by shape and dtype as the reference's scan-stacked residuals under
   "names"; "full" keeps the unit's input.
   Under "none" and "full" the marks dispatch no op; under "names" one
   alias a named tensor.
4. ROADMAP C.30: on the same inputs the reference's "scores" keeps exactly
   its "none"'s residuals, (S, T) tensors among them; the port's keeps none.
5. ROADMAP C.31: the products the backward under "names" runs beyond
   "none"'s are the reference's recompute and nothing else: for llama_60m
   QKᵀ, wo, gate and up once each a layer; for Scout (MoE, an iRoPE group)
   QKᵀ, wo and the whole MoE but its combine; for whisper_small QKᵀ, wo
   and up in every layer, and the cross-attention's q projection — never a
   self-attention q/k/v projection, PV or down (≈ 2 s of CPU for the three).
"""
import collections
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rope as jrope  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import stacks as jstacks  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch.dryrun import LiveBytes, allocator_bytes  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import remat  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import stacks as tstacks  # noqa: E402
from repro_torch.utils import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ARCHS = ["llama_60m", "llama4_scout_17b_a16e", "qwen2_vl_7b", "mamba2_130m",
         "jamba_1_5_large_398b", "whisper_small"]
SSD_ARCHS = ("mamba2_130m", "jamba_1_5_large_398b")  # C.20: gradients held a unit
POLICIES = ["scores", "names", "full"]
B, S = 2, 13


def _close(got, want, name, tol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-6), err_msg=name)


def _jflat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _model(arch, enc_seq=None):
    """(port cfg, port params, numpy batch): whisper's dec_pos and frames
    drawn (`enc_seq` frames, the smoke config's unless given), qwen2_vl's
    (3, B, S) positions with differing rows and media."""
    cfg = get_config(arch, smoke=True)
    if enc_seq is not None:
        cfg = dataclasses.replace(cfg, enc_seq=enc_seq)
    params = TM.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "loss_mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
    if cfg.family == "vlm":
        s = np.arange(S)
        rows = np.stack([s // 4, s // 2 % 3, s % 4 + s // 8]).astype(np.int32)
        batch["positions"] = np.broadcast_to(rows[:, None], (3, B, S)).copy()
        batch["media"] = (0.1 * rng.standard_normal((B, cfg.media_embeds, cfg.d_model))
                          ).astype(np.float32)
    if cfg.family == "audio":
        batch["enc_frames"] = (0.1 * rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                               ).astype(np.float32)
        pos = 0.02 * rng.standard_normal(tuple(params["dec_pos"].shape))
        with torch.no_grad():
            params["dec_pos"].copy_(torch.from_numpy(pos.astype(np.float32)))
    return cfg, params, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _port_run(arch, policy):
    """The port's (total, aux_loss, gradients of every leaf) under `policy`."""
    cfg, params, batch = _model(arch)
    total, metrics = TM.loss_fn(dataclasses.replace(cfg, remat=policy), params,
                                _torch_batch(batch))
    grads = torch.autograd.grad(total, tree_leaves(params))
    return total.detach(), metrics["aux_loss"], grads


# ---------------------------------------------------------------------------
# 1. every policy bit for bit "none"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_equals_none_bitwise(arch, policy):
    """Loss, aux_loss and every gradient leaf under `policy` equal "none"'s
    bit for bit: the recompute reruns the same ops on the same values."""
    cfg = _model(arch)[0]
    assert (cfg.n_experts > 0) == (float(_port_run(arch, "none")[1]) > 0)
    got, want = _port_run(arch, policy), _port_run(arch, "none")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for (path, _), g, w in zip(tree_leaves_with_path(_model(arch)[1]), got[2], want[2]):
        assert torch.equal(g, w), path


# ---------------------------------------------------------------------------
# 2. against JAX under the same policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_matches_jax(arch, policy):
    """Loss and aux_loss within 1e-5·max of JAX's loss_fn under the same
    policy; every gradient leaf too, at the model, for the attention
    families (the SSD families' are held a unit below, C.20)."""
    cfg, params, batch = _model(arch)
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), remat=policy)
    jparams = tree_map(jnp.asarray, params_to_numpy(params))
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
          for k, v in batch.items()}
    total, aux, grads = _port_run(arch, policy)
    if arch in SSD_ARCHS:
        jtotal, jmetrics = jax.jit(lambda p: JM.loss_fn(jcfg, p, jb))(jparams)
    else:
        (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(
            lambda p: JM.loss_fn(jcfg, p, jb), has_aux=True))(jparams)
        jflat = _jflat(jgrads)
        leaves = tree_leaves_with_path(params)
        assert sorted(jflat) == [path for path, _ in leaves]
        for (path, _), g in zip(leaves, grads):
            _close(g, jflat[path], f"grad {path}")
    _close(total, jtotal, "total")
    _close(aux, jmetrics["aux_loss"], "aux_loss")


def _unit_loss(jcfg, body):
    """JAX: value_and_grad of sum(y·w) + aux over the reference's
    ``_remat_wrap(jcfg, body)`` (body(p, x, angles) -> (y, aux))."""
    wrapped = jstacks._remat_wrap(jcfg, body)

    def loss(p, x, w, angles):
        y, aux = wrapped(p, x, angles)
        return jnp.sum(y * w) + aux, (y, aux)

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))


@functools.lru_cache(maxsize=None)
def _jax_ssd_layer(policy):
    jcfg = dataclasses.replace(jax_get_config("mamba2_130m", smoke=True), remat=policy)

    def body(p, x, angles):
        h = jlayers.apply_norm(jcfg, p["ln"], x)
        return x + jssm.apply_ssm(jcfg, p["mix"], h)[0], jnp.zeros((), jnp.float32)

    return _unit_loss(jcfg, body)


@functools.lru_cache(maxsize=None)
def _jax_jamba_sublayer(policy, kind, is_moe):
    jcfg = dataclasses.replace(jax_get_config("jamba_1_5_large_398b", smoke=True), remat=policy)

    def body(p, x, angles):
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
        return x + out, aux

    return _unit_loss(jcfg, body)


def _check_unit(cfg, policy, fn, sp, jfn, seed, jangles=None):
    """fn(x) -> (y, aux), one unit run through stacks.run_units under
    `policy`, against jfn (the reference's wrapped body) on the same x,
    cotangent w and params `sp`: y, aux and the gradients of x and of every
    leaf within 1e-5·max."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    (_, (jy, jaux)), (jgp, jgx) = jfn(tree_map(jnp.asarray, params_to_numpy(sp)), x, w,
                                      jangles)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tstacks.run_units(dataclasses.replace(cfg, remat=policy), lambda x, u: fn(x), xt,
                               1, None)
    _close(y, jy, "y")
    _close(aux, jaux, "aux")
    leaves = tree_leaves_with_path(sp)
    gs = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux, [xt] + [t for _, t in leaves])
    _close(gs[0], jgx, "grad x")
    jflat = _jflat(jgp)
    assert sorted(jflat) == [path for path, _ in leaves]
    for (path, _), g in zip(leaves, gs[1:]):
        _close(g, jflat[path], f"grad {path}")


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("policy", POLICIES)
def test_ssd_layer_under_policy_matches_jax(policy, layer):
    """Each mamba2_130m layer (pre-norm residual SSD) as a unit under the
    policy against the reference's wrapped layer (C.20)."""
    cfg, params, _ = _model("mamba2_130m")
    lp = tree_map(lambda t: t.detach()[layer].clone().requires_grad_(True), params["blocks"])

    def fn(x):
        y = x + tssm.apply_ssm(cfg, lp["mix"], TL.apply_norm(cfg, lp["ln"], x))
        return y, torch.zeros((), dtype=torch.float32)

    _check_unit(cfg, policy, fn, lp, _jax_ssd_layer(policy), seed=20 + layer)


@pytest.mark.parametrize("offset", range(8))
@pytest.mark.parametrize("policy", POLICIES)
def test_jamba_sublayer_under_policy_matches_jax(policy, offset):
    """Each of the Jamba block's 8 sub-layers (the attention one at offset
    4, MoE on the odd ones) as a unit under the policy against the
    reference's wrapped sub-layer (C.20)."""
    cfg, params, _ = _model("jamba_1_5_large_398b")
    kind, is_moe = tstacks._jamba_block_structure(cfg)[offset]
    sp = tree_map(lambda t: t.detach()[0].clone().requires_grad_(True), params["blocks"][offset])
    jcfg = jax_get_config("jamba_1_5_large_398b", smoke=True)
    jangles = jrope.rope_angles(jrope.positions_for(jcfg, B, S), jcfg.resolved_head_dim,
                                jcfg.rope_theta)
    angles = TM._angles(cfg, None, S, B, torch.device("cpu"))

    def fn(x):
        y, aux = tstacks.jamba_sublayer(cfg, kind, is_moe, sp, x, angles=angles)
        return y, torch.zeros((), dtype=torch.float32) if aux is None else aux

    _check_unit(cfg, policy, fn, sp, _jax_jamba_sublayer(policy, kind, is_moe),
                seed=10 + offset, jangles=jangles)


class _Ops(TorchDispatchMode):
    """Records every aten op dispatched under it, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _ops(arch, policy):
    cfg, params, batch = _model(arch)
    with _Ops() as rec:
        total, _ = TM.loss_fn(dataclasses.replace(cfg, remat=policy), params, _torch_batch(batch))
        n_forward = len(rec.ops)
        torch.autograd.grad(total, tree_leaves(params))
    return rec.ops, n_forward


@pytest.mark.parametrize("policy", ["none", "full"])
@pytest.mark.parametrize("arch", ["llama_60m", "whisper_small"])
def test_marks_cost_nothing_under_none_and_full(arch, policy, monkeypatch):
    """Under "none" and "full" the forward and backward dispatch exactly the
    aten ops, in order, that they dispatch with remat.name and
    remat.scores_core replaced by plain calls: no copy, no op."""
    got = _ops(arch, policy)
    monkeypatch.setattr(remat, "name", lambda x, tag: x)
    monkeypatch.setattr(remat, "scores_core", lambda core, q, k, v: core(q, k, v))
    assert got == _ops(arch, policy)


@pytest.mark.parametrize("arch", ["llama_60m", "whisper_small"])
def test_names_marks_five_tensors_a_layer(arch):
    """Under "names" the forward adds one alias a named tensor: five a
    self-attention layer with its MLP (q, k, v, the context, the FFN
    hidden), one for cross-attention (its context)."""
    cfg = _model(arch)[0]
    ops, n_forward = _ops(arch, "names")
    aliases = sum(op is torch.ops.aten.alias.default for op in ops[:n_forward])
    want = (5 * cfg.n_layers if cfg.family != "audio"
            else 5 * cfg.n_enc_layers + 6 * cfg.n_layers)
    assert aliases == want


# ---------------------------------------------------------------------------
# 3. what each policy keeps: llama_60m smoke, bf16, 2 × 40, on meta tensors
# ---------------------------------------------------------------------------

KB, KS = 2, 40


def _kept_cfg(policy, n_layers=2):
    return dataclasses.replace(get_config("llama_60m", smoke=True), dtype="bfloat16",
                               remat=policy, n_layers=n_layers)


@functools.lru_cache(maxsize=None)
def _kept(policy, n_layers=2):
    """(bytes, Counter of (shape, dtype) of each storage) that the forward
    leaves alive for the backward, as LiveBytes counts them on meta
    tensors, above the resident params and batch."""
    cfg = _kept_cfg(policy, n_layers)
    params = TM.init_params(cfg, device="meta")
    tokens = torch.zeros((KB, KS), dtype=torch.int64, device="meta")
    with LiveBytes(tree_leaves(params) + [tokens]) as live:
        loss = TM.loss_fn(cfg, params, {"tokens": tokens})  # its graph holds what is kept
        kept = live.now - live.base, collections.Counter(live.held())
    del loss
    return kept


def _one_layer(policy):
    """What one layer more keeps: (bytes, Counter of (numel, dtype))."""
    (b2, h2), (b1, h1) = _kept(policy, 2), _kept(policy, 1)
    return b2 - b1, _by_numel(h2) - _by_numel(h1), h2 - h1


def _by_numel(held):
    out = collections.Counter()
    for (shape, dtype), n in held.items():
        out[math.prod(shape), dtype] += n
    return out


def _analytic(shapes):
    """(bytes as the caching allocator counts them, Counter of (numel,
    dtype)) of tensors `shapes` {name: (shape, dtype)}."""
    nbytes = sum(allocator_bytes(math.prod(s) * d.itemsize) for s, d in shapes.values())
    return nbytes, collections.Counter((math.prod(s), d) for s, d in shapes.values())


def _named_shapes():
    """The unit's input and the reference's five named tensors at the kept
    config: x and the context (B, S, D = H·hd), q (B, S, H, hd), k and v
    (B, S, KV, hd), the FFN hidden (B, S, F), all bf16."""
    cfg, bf = _kept_cfg("names"), torch.bfloat16
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {"x": ((KB, KS, cfg.d_model), bf), "save_q": ((KB, KS, H, hd), bf),
            "save_k": ((KB, KS, KV, hd), bf), "save_v": ((KB, KS, KV, hd), bf),
            "save_attn_ctx": ((KB, KS, H * hd), bf), "save_ffn_hidden": ((KB, KS, cfg.d_ff), bf)}


def _st(shape):
    return len(shape) >= 2 and tuple(shape[-2:]) == (KS, KS)


def test_scores_keeps_none_s_less_the_attention_core():
    """"scores" keeps "none"'s less, each layer, the core's tensors: the
    mask ~m (1, 1, 1, S, S) bool, exp(scores − m) (B, K, G, S, S) f32, its row
    sums (B, K, G, S, 1) f32 and the probabilities in V's dtype (bf16); no
    storage of shape (…, S, S) stays alive, where "none" keeps three a layer."""
    cfg = _kept_cfg("scores")
    K, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    core = {"mask": ((1, 1, 1, KS, KS), torch.bool),
            "exp": ((KB, K, G, KS, KS), torch.float32),
            "row sums": ((KB, K, G, KS, 1), torch.float32),
            "probs": ((KB, K, G, KS, KS), torch.bfloat16)}
    nbytes, _ = _analytic(core)
    none_b, none_h = _kept("none")
    scores_b, scores_h = _kept("scores")
    assert none_b - scores_b == cfg.n_layers * nbytes
    assert sum(n for (s, _), n in none_h.items() if _st(s)) == 3 * cfg.n_layers
    assert not [s for s, _ in scores_h if _st(s)]


def test_names_keeps_the_unit_input_and_the_five_named_tensors():
    """"names" keeps, each layer, exactly its input and the five named
    tensors, by bytes and by (elements, dtype) of each storage."""
    nbytes, want = _analytic(_named_shapes())
    got_b, got, _ = _one_layer("names")
    assert got_b == nbytes and got == want


def test_names_set_is_the_reference_s_scan_stacked_residuals():
    """The reference's "names" at the same config (bf16, 2 × 40) keeps, as
    outputs of its layer scan, each stacked (L, …), exactly the port's named
    set by shape and dtype. Left out, each by its source: the parameter
    views (the scan body's per-layer weight slices, outputs of reshape), the
    rope table (rope_angles' f32 angles), the embedding's indices, and the
    final norm's and the loss's residuals (a bool (B, S) among them), which
    lie outside the stack; no mask is kept under "names"."""
    jcfg = dataclasses.replace(jax_get_config("llama_60m", smoke=True), dtype="bfloat16",
                               remat="names")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((KB, KS), jnp.int32)}
    res = [(a, src) for a, src in saved_residuals(
        lambda p: JM.loss_fn(jcfg, p, batch)[0], jparams) if "from the argument" not in src]
    stacked = [a for a, src in res if "output of scan" in src]
    rest = [src for a, src in res if "output of scan" not in src]
    assert all(any(k in src for k in ("output of reshape", "rope_angles", "_take", "apply_norm",
                                      "loss_fn")) for src in rest), rest
    assert all(a.shape[0] == jcfg.n_layers for a in stacked)
    got = collections.Counter((tuple(a.shape[1:]), str(a.dtype)) for a in stacked)
    want = collections.Counter((s, str(d).replace("torch.", ""))
                               for s, d in _named_shapes().values())
    assert got == want
    _, port, _ = _one_layer("names")
    assert port == _analytic(_named_shapes())[1]


def test_full_keeps_the_unit_input():
    cfg = _kept_cfg("full")
    got_b, got, _ = _one_layer("full")
    assert (got_b, got) == _analytic({"x": ((KB, KS, cfg.d_model), torch.bfloat16)})


def test_kept_bytes_rank_none_scores_names_full():
    assert _kept("none")[0] > _kept("scores")[0] > _kept("names")[0] > _kept("full")[0]


# ---------------------------------------------------------------------------
# 4. ROADMAP C.30: the reference's "scores" keeps what its "none" keeps
# ---------------------------------------------------------------------------


def test_reference_scores_keeps_none_s_residuals_the_port_s_does_not():
    """On the same inputs (llama_60m smoke, bf16, 2 × 40, arguments left
    out) the reference's "scores" keeps its "none"'s 55 residuals of
    1,247,444 bytes, (S, T) tensors among them — its policy names the
    scores and probabilities, and the exp and the bf16 cast beside them
    carry no name; the port's "scores" keeps no (S, T) tensor."""
    def residuals(policy):
        jcfg = dataclasses.replace(jax_get_config("llama_60m", smoke=True), dtype="bfloat16",
                                   remat=policy)
        jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
        batch = {"tokens": jnp.zeros((KB, KS), jnp.int32)}
        return [(tuple(a.shape), str(a.dtype)) for a, src in saved_residuals(
            lambda p: JM.loss_fn(jcfg, p, batch)[0], jparams) if "from the argument" not in src]

    none, scores = residuals("none"), residuals("scores")
    assert collections.Counter(scores) == collections.Counter(none)
    assert len(scores) == 55
    assert sum(math.prod(s) * np.dtype(d).itemsize for s, d in scores) == 1_247_444
    assert [s for s, _ in scores if _st(s)]
    assert not [s for s, _ in _kept("scores")[1] if _st(s)]


# ---------------------------------------------------------------------------
# 5. ROADMAP C.31: "names" replays only what its backward reads
# ---------------------------------------------------------------------------

_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


class _Products(TorchDispatchMode):
    """Records each mm / bmm as (op, shapes, strides, the parameter each
    operand views as (leaf path, storage offset) or None)."""

    def __init__(self, owners):
        super().__init__()
        self.owners, self.ops = owners, []

    def _param(self, t):
        path = self.owners.get(t.untyped_storage()._cdata)
        return None if path is None else (path, t.storage_offset())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _PRODUCTS:
            self.ops.append((func, tuple(tuple(a.shape) for a in args),
                             tuple(a.stride() for a in args), tuple(map(self._param, args))))
        return func(*args, **(kwargs or {}))


def _products(arch, policy):
    """(the forward's products, the backward's) of loss_fn under `policy`;
    whisper at 24 frames, so that no QKᵀ has PV's shapes (its head dim is
    the smoke config's 16 frames)."""
    cfg, params, batch = _model(arch, 24 if arch == "whisper_small" else None)
    owners = {t.untyped_storage()._cdata: path for path, t in tree_leaves_with_path(params)}
    with _Products(owners) as fwd:
        total, _ = TM.loss_fn(dataclasses.replace(cfg, remat=policy), params,
                              _torch_batch(batch))
    with _Products(owners) as bwd:
        torch.autograd.grad(total, tree_leaves(params))
    return fwd.ops, bwd.ops


def _label(op, n_core):
    """A forward product's name: its weight's leaf path less the stack's
    ("attn.wo", "cross_attn.wq", "ffn.up", …), or, for a product of two
    activations, "qk" and "pv" in turn (each attention core's two)."""
    params = [p for p in op[3] if p is not None]
    if params:
        return params[0][0].split(".", 1)[1]
    return ("qk", "pv")[n_core % 2]


# the forward's products the reference's "names" recomputes
RECOMPUTED = {
    "llama_60m": {"qk", "attn.wo", "ffn.gate", "ffn.up"},
    "llama4_scout_17b_a16e": {"qk", "attn.wo", "ffn.router", "ffn.gate", "ffn.up", "ffn.down"},
    "whisper_small": {"qk", "attn.wo", "self_attn.wo", "cross_attn.wq", "cross_attn.wo",
                      "ffn.up"},
}


@pytest.mark.parametrize("arch", sorted(RECOMPUTED))
def test_names_backward_replays_only_what_it_reads(arch):
    """The backward under "names" runs "none"'s products and, beyond them,
    exactly the forward's products named in RECOMPUTED, each once: no
    self-attention q/k/v projection, no PV, no down of a dense MLP; the
    loss head's product is not replayed either."""
    fwd, none_bwd = _products(arch, "none")
    _, names_bwd = _products(arch, "names")
    labels, n_core = [], 0
    for op in fwd:
        labels.append(_label(op, n_core))
        n_core += all(p is None for p in op[3])
    want = collections.Counter(op for op, lab in zip(fwd, labels) if lab in RECOMPUTED[arch])
    got = collections.Counter(names_bwd) - collections.Counter(none_bwd)
    assert not collections.Counter(none_bwd) - collections.Counter(names_bwd)
    assert got == want
    replayed = {lab for op, lab in zip(fwd, labels) if op in got}
    assert not replayed & {"pv", "attn.wq", "attn.wk", "attn.wv", "self_attn.wq", "self_attn.wk",
                           "self_attn.wv"}, replayed
    qk = {op for op, lab in zip(fwd, labels) if lab == "qk"}
    assert sum(n for op, n in got.items() if op in qk) == labels.count("qk") == labels.count("pv")
