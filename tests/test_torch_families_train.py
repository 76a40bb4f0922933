"""Training and serving the MoE family in the port against the JAX package,
on the Llama-4 Scout smoke config (f32, 4 layers: one iRoPE group, 4 experts
top-1, chunk 8), whose expert leaves are 4-D (L, E, m, n) and whose router
is an f32 (L, D, E) leaf that stays on Adam.

1. A JAX GaLore-AdamW run (the composable path, no Pallas) checkpoints at
   step 1: the checkpoint restores in the port bit for bit, and the port's
   state after its next step restores in JAX bit for bit; that step (the
   fused step, every 4-D leaf L·E slabs) lands within 2e-5 of JAX's.
2. A 20-step GaLore trajectory (rank 16, T 10) within 5e-2 of JAX's.
3. The serving engine's greedy tokens equal JAX's Engine's and the full
   forward's, on a prompt that crosses two chunk boundaries (ample MoE
   capacity).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticC4 as JSyntheticC4  # noqa: E402
from repro.distributed.step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.subspace import SubspaceManager  # noqa: E402
from repro_torch.distributed.step import make_train_step  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402
from repro_torch.utils import tree_leaves_with_path, tree_map  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ARCH = "llama4_scout_17b_a16e"
STEPS, BATCH, SEQ = 20, 4, 32
_G = dict(rank=16, update_freq=10, scale=0.25)


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
def jax_run(tmp_path_factory):
    """One JAX GaLore run from the port's initial weights: a checkpoint at
    step 1, the params and loss of step 2, and the 20 steps' losses."""
    jcfg = jax_get_config(ARCH, smoke=True)
    jdata = JSyntheticC4(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                     batch_per_host=BATCH))
    p0 = TM.init_params(get_config(ARCH, smoke=True), seed=0, device="cpu")
    jp = tree_map(jnp.asarray, params_to_numpy(p0))
    jtc, _ = _train_configs()
    step_fn, jopt = jax_make_train_step(jcfg, jtc)
    step_fn = jax.jit(step_fn)
    js = jax.jit(jopt.init)(jp)
    init = {"params": jp, "opt_state": js}
    root = tmp_path_factory.mktemp("jax_moe")
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
    """The port's step and its state restored from the checkpoint at step 1
    under `root`."""
    cfg = get_config(ARCH, smoke=True)
    _, tc = _train_configs()
    step_fn, opt = make_train_step(cfg, tc)
    params = TM.init_params(cfg, seed=0, device="cpu")
    target = {"params": params, "opt_state": opt.init(params)}
    return CheckpointManager(str(root), async_save=False).restore(1, target), step_fn, tc


def test_jax_checkpoint_of_moe_restores_in_port_and_back(jax_run, tmp_path):
    """The JAX GaLore checkpoint lands in the port's state bit for bit: the
    f32 router in the f32 tree, the 4-D expert leaves' projectors (L, E, m,
    r) and compact moments; the port's state after its next step, saved by
    the port, restores in the JAX manager bit for bit."""
    restored, step_fn, _ = _restore(jax_run["root"])
    _bitwise(_flat(restored), jax_run["saved"])
    assert restored["params"]["blocks"]["ffn"]["router"].dtype == torch.float32
    galore_state = restored["opt_state"][1]
    assert galore_state["proj"]["blocks"]["ffn"]["gate"].shape == (4, 4, 64, 16)
    assert galore_state["inner"]["m"]["blocks"]["ffn"]["down"].shape == (4, 4, 128, 16)
    params, opt_state, _ = step_fn(restored["params"], restored["opt_state"],
                                   _Bridged(jax_run["data"]).batch(2))
    port_tree = {"params": params, "opt_state": opt_state}
    CheckpointManager(str(tmp_path), async_save=False).save(2, port_tree, block=True)
    back = JCheckpointManager(str(tmp_path), async_save=False).restore(2, jax_run["init"])
    _bitwise(_jflat(back), _flat(port_tree))


def test_galore_update_on_expert_leaves_matches_jax(jax_run):
    """From the restored step-1 state, the port's fused GaLore step (every
    4-D expert leaf as L·E = 16 slabs, gate/up on the left, down on the
    right, the router on Adam) on JAX's step-2 batch: loss and every
    parameter within 2e-5 of JAX's step."""
    restored, step_fn, tc = _restore(jax_run["root"])
    plans = dict(tree_leaves_with_path(SubspaceManager(tc.galore).plans(restored["params"])))
    assert plans["blocks.ffn.gate"].galore and plans["blocks.ffn.gate"].side == "left"
    assert plans["blocks.ffn.down"].galore and plans["blocks.ffn.down"].side == "right"
    assert not plans["blocks.ffn.router"].galore
    params, _, metrics = step_fn(restored["params"], restored["opt_state"],
                                 _Bridged(jax_run["data"]).batch(2))
    assert abs(float(metrics["loss"]) - jax_run["next_loss"]) <= 2e-5
    got = _flat(params)
    for k, want in jax_run["next_params"].items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=2e-5, err_msg=k)


def test_galore_trajectory_on_moe_matches_jax(jax_run, tmp_path):
    """The port's fused GaLore steps (rank 16, T 10: refreshes at 0 and 10)
    on the JAX pipeline's batches, per-step losses within 5e-2 of JAX's
    composable run, and falling."""
    _, tc = _train_configs()
    got = []
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), jax_run["p0"])
    train_loop(RunConfig(steps=STEPS, batch_per_host=BATCH, seq_len=SEQ, log_every=STEPS,
                         ckpt_dir=str(tmp_path), device="cpu"),
               tc, cfg=get_config(ARCH, smoke=True), params=params,
               data=_Bridged(jax_run["data"]), on_step=lambda s, m: got.append(
                   (float(m["loss"]), float(m["aux_loss"]))))
    np.testing.assert_allclose([g[0] for g in got], jax_run["losses"], rtol=0, atol=5e-2)
    assert got[-1][0] < got[0][0] and all(a > 0 for _, a in got)


def test_engine_greedy_on_chunked_moe_matches_jax():
    """Two requests, one of 21 prompt tokens (positions cross the chunk
    boundaries at 8 and 16), prefill chunks of 6: the port's Engine gives
    JAX's Engine's tokens and the full-forward greedy rollout's."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), capacity_factor=8.0)
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True), capacity_factor=8.0)
    params = TM.init_params(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in (21, 3)]
    scfg = ServeConfig(block_size=4, num_blocks=32, slots=2, max_len_cap=36, prefill_chunk=6)
    eng = Engine(cfg, params, scfg)
    ids = [eng.submit(Request(tokens=p, max_new=6)) for p in prompts]
    eng.run_until_drained(timeout_s=300)
    got = [list(eng.result(i).tokens) for i in ids]

    jeng = jserve.Engine(jcfg, tree_map(jnp.asarray, params_to_numpy(params)),
                         jserve.ServeConfig(4, 32, 2, 36, 6))
    jids = [jeng.submit(jserve.Request(tokens=p, max_new=6)) for p in prompts]
    jeng.run_until_drained(timeout_s=300)
    assert got == [list(jeng.result(i).tokens) for i in jids]

    for p, toks in zip(prompts, got):
        seq = list(p)
        with torch.no_grad():
            for _ in range(6):
                seq.append(int(TM.forward(cfg, params, {"tokens": torch.tensor([seq])})[0, -1]
                               .argmax()))
        assert toks == seq[len(p):]
