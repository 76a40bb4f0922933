"""The port's training slice end to end: a 20-step GaLore-Adam run on the
llama_60m smoke config from the JAX package's weights and batches, against
the JAX package's own run; and the launcher's refusal to fall back to the CPU."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticC4 as JSyntheticC4  # noqa: E402
from repro.distributed.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticC4  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.utils import tree_leaves_with_path  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

STEPS, BATCH, SEQ = 20, 4, 64


class _Bridged:
    """The JAX pipeline's batches as CPU tensors."""

    def __init__(self, jdata):
        self.jdata = jdata

    def batch(self, step):
        b = self.jdata.batch(step)
        return {"tokens": torch.tensor(np.asarray(b["tokens"]), dtype=torch.int64),
                "targets": torch.tensor(np.asarray(b["targets"]), dtype=torch.int64),
                "loss_mask": torch.tensor(np.asarray(b["loss_mask"]))}


@pytest.mark.parametrize("fused", [True, False])
def test_galore_trajectory_matches_jax(fused, tmp_path):
    """Per-step losses within 5e-2 of the JAX run (rank 16, T 10: SVD
    refreshes at steps 0 and 10)."""
    jcfg = jax_get_config("llama_60m", smoke=True)
    jtc = JTrainConfig(optimizer="adamw", galore=JGaLoreConfig(rank=16, update_freq=10),
                       galore_fused_adam=fused, total_steps=STEPS, warmup_steps=2)
    jdata = JSyntheticC4(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ, batch_per_host=BATCH))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")

    step_fn, jopt = jax_make_train_step(jcfg, jtc)
    step_fn = jax.jit(step_fn)
    jstate = jopt.init(jparams)
    want = []
    for s in range(STEPS):
        jparams, jstate, metrics = step_fn(jparams, jstate, jdata.batch(s))
        want.append(float(metrics["loss"]))

    got = []
    tc = TrainConfig(optimizer="adamw", galore=GaLoreConfig(rank=16, update_freq=10),
                     galore_fused_adam=fused, total_steps=STEPS, warmup_steps=2)
    train_loop(RunConfig(steps=STEPS, batch_per_host=BATCH, seq_len=SEQ, log_every=STEPS,
                         ckpt_dir=str(tmp_path), device="cpu"),
               tc, cfg=get_config("llama_60m", smoke=True), params=tparams, data=_Bridged(jdata),
               on_step=lambda s, m: got.append(float(m["loss"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
    assert want[-1] < want[0]


def test_microbatch_accumulation_matches_full_batch():
    """microbatch=2 averages the f32 gradients of two halves; with the same
    loss-mask count in each half that is the full batch's gradient."""
    from repro_torch.distributed.step import _grads_and_loss
    from repro_torch.models import model as TM

    cfg = get_config("llama_60m", smoke=True)
    params = TM.init_params(cfg, seed=0, device="cpu")
    batch = SyntheticC4(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, batch_per_host=4),
                        device="cpu").batch(0)
    loss_of = lambda p, b: TM.loss_fn(cfg, p, b)  # noqa: E731
    full = _grads_and_loss(TrainConfig(), loss_of, params, batch)
    micro = _grads_and_loss(TrainConfig(microbatch=2), loss_of, params, batch)
    torch.testing.assert_close(micro[0], full[0], rtol=1e-5, atol=1e-6)
    for path, g in tree_leaves_with_path(micro[2]):
        want = dict(tree_leaves_with_path(full[2]))[path]
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()),
                                   msg=path)


def test_pipeline_is_deterministic_and_shaped():
    data = SyntheticC4(DataConfig(vocab_size=512, seq_len=16, batch_per_host=3), device="cpu")
    a, b = data.batch(5), data.batch(5)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["tokens"].shape == (3, 16) and int(a["tokens"].max()) < 512
    assert torch.equal(a["targets"][:, :-1], a["tokens"][:, 1:])
    assert float(a["loss_mask"][:, -1].sum()) == 0.0
    assert not torch.equal(a["tokens"], data.batch(6)["tokens"])


def test_cli_refuses_cpu_fallback(capsys, monkeypatch):
    """With no GPU and no --device cpu the launcher exits with a clear error
    (in process, the process seeing no CUDA device)."""
    from repro_torch.launch import train as launcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exit_info:
        launcher.main(["--steps", "1"])
    assert exit_info.value.code != 0
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err
