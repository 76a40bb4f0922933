"""Port model: logits, loss and every gradient leaf against the JAX package
on the llama_60m smoke config (f32), from the same weights and batch; the
config registry against the reference's."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, NOT_PORTED, get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.utils import tree_leaves_with_path  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401


def _close(got, want, name):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1e-6), err_msg=name)


def test_config_copy_matches_reference():
    """Every architecture the port registers, full and smoke, equal to the
    reference's config in every ModelConfig field."""
    assert set(ARCH_IDS) | set(NOT_PORTED) == set(JAX_ARCH_IDS)
    for arch in ("llama_60m", "llama_130m", "llama_350m", "llama_1b", "llama_7b", *ARCH_IDS):
        for smoke in (True, False):
            want = jax_get_config(arch, smoke=smoke)
            got = get_config(arch, smoke=smoke)
            assert [f.name for f in dataclasses.fields(got)] == \
                [f.name for f in dataclasses.fields(want)]
            for f in dataclasses.fields(want):
                assert getattr(got, f.name) == getattr(want, f.name), (arch, smoke, f.name)
            for prop in ("padded_vocab", "resolved_head_dim"):
                if prop == "resolved_head_dim" and want.n_heads == 0:  # attention-free
                    with pytest.raises(ZeroDivisionError):
                        getattr(want, prop)
                    with pytest.raises(ZeroDivisionError):
                        getattr(got, prop)
                    continue
                assert getattr(got, prop) == getattr(want, prop), (arch, smoke, prop)
            TM.check_ported(got)


def test_unported_configs_refused():
    """What the port still refuses: no architecture of the reference
    (NOT_PORTED is empty, whisper_small registered); check_ported and
    init_params refuse the remat policies "scores" and "names", and accept
    every family, LayerNorm, GELU and remat none and full."""
    assert NOT_PORTED == ()
    assert get_config("whisper_small").family == jax_get_config("whisper_small").family == "audio"
    base = get_config("qwen2_7b", smoke=True)
    for remat in ("scores", "names"):
        bad = dataclasses.replace(base, remat=remat)
        with pytest.raises(NotImplementedError, match="remat"):
            TM.check_ported(bad)
        with pytest.raises(NotImplementedError, match="remat"):
            TM.init_params(bad, device="cpu")
    for field, value in (("remat", "none"), ("remat", "full"), ("norm_type", "layernorm"),
                         ("act", "gelu"), *(("family", f) for f in ("ssm", "hybrid", "audio"))):
        TM.check_ported(dataclasses.replace(base, **{field: value}))
    with pytest.raises(NotImplementedError, match="family"):
        TM.check_ported(dataclasses.replace(base, family="unknown"))


def test_loss_and_grads_match_jax():
    cfg = get_config("llama_60m", smoke=True)
    jparams = JM.init_params(jax_get_config("llama_60m", smoke=True), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 32))
    mask = np.ones((2, 32), np.float32)
    mask[:, -1] = 0.0
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32), "loss_mask": jnp.asarray(mask)}
    jcfg = jax_get_config("llama_60m", smoke=True)

    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jbatch), has_aux=True))(jparams)
    jlogits, _, _ = jax.jit(lambda p: JM.forward(jcfg, p, jbatch))(jparams)

    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    batch = {"tokens": torch.from_numpy(tokens), "loss_mask": torch.from_numpy(mask)}
    _close(TM.forward(cfg, params, batch), jlogits, "logits")
    loss, _ = TM.loss_fn(cfg, params, batch)
    _close(loss, jloss, "loss")

    leaves = tree_leaves_with_path(params)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    jflat = {".".join(str(k.key) for k in path): g
             for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert sorted(jflat) == [path for path, _ in leaves]
    for (path, _), g in zip(leaves, grads):
        _close(g, jflat[path], f"grad {path}")
