"""The port's checkpoints (repro_torch/checkpoint/manager.py) and the
launcher's resume and preemption, against the JAX package's manager.

1. the reference's manager tests, ported: round trip, keep-N GC, tmp litter,
   async save and its failure, the leaf copy made before save returns,
   torn / unparseable / bit-flipped files, the checksum-off META layout, the
   int8 / int4 file codec (codes and scales bit for bit the reference's
   ``_np_quantize``) and the refusals;
2. for each state form the port runs (AdamW, GaLore fp32 emit and apply,
   8-bit GaLore with int8 moments and int4 P, 8-bit Adam, Adafactor,
   GaLore-Adafactor and SGD with momentum): a JAX checkpoint
   restored by the port and a port checkpoint restored by the JAX manager,
   every leaf bit for bit, with the same npz keys and META dtypes, and the
   port's next step from the JAX checkpoint within 2e-5 of JAX's;
3. the port's resume (6 steps + save + resume + 6 = 12 straight, bit for
   bit, with a refresh after the resume point) and PREEMPT;
4. the async refresh's checkpoints: a save with a refresh in flight carries
   the ``pending`` group (and, under adaptive T, the ``schedule`` scalars);
   one written by the reference's driver restores in the port and resumes
   where the JAX run goes on (losses within 5e-2), one written by the port
   restores in the JAX manager bit for bit, and the port's resume lands the
   same swap as the uninterrupted run, bit for bit.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch.checkpoint.manager as manager_module  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.checkpoint.manager import _np_quantize as jax_np_quantize  # noqa: E402
from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.distributed.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.quant import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.utils import path_str as jax_path_str  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.distributed.step import make_train_step  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402
from repro_torch.utils import tree_leaves_with_path, tree_map  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

SEQ, BATCH = 32, 2


def _np(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x, np.int32) if isinstance(x, int) else np.asarray(x)


def _flat(tree):
    """{dotted path: numpy leaf} of a port tree."""
    return {k: _np(v) for k, v in tree_leaves_with_path(tree)}


def _jflat(tree):
    """{dotted path: numpy leaf} of a JAX tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax_path_str(p): np.asarray(v) for p, v in flat}


def _assert_trees_bitwise(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# 1. the manager
# ---------------------------------------------------------------------------


def _save_steps(root, steps, **kw):
    ckpt = CheckpointManager(str(root), async_save=False, **kw)
    for s in steps:
        ckpt.save(s, {"x": torch.full((8,), float(s))}, block=True)
    return ckpt


def test_checkpoint_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16) / 3, "n": 7}}
    ckpt.save(7, tree, extra_meta={"note": "x"}, block=True)
    assert ckpt.latest_step() == 7 and ckpt.meta(7)["note"] == "x"
    assert ckpt.groups(7) == ("a", "nested")
    assert ckpt.meta(7)["dtypes"] == {"a": "float32", "nested.b": "bfloat16", "nested.n": "int32"}
    with np.load(tmp_path / "step_00000007" / "host_0.npz") as z:
        assert z["nested.b"].dtype == np.float32  # bf16 widened, exactly
    zeros = tree_map(lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor) else 0, tree)
    restored = ckpt.restore(7, zeros)
    assert torch.equal(restored["a"], tree["a"]) and restored["nested"]["n"] == 7
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])


def test_checkpoint_gc_keeps_latest(tmp_path):
    assert _save_steps(tmp_path, [1, 2, 3, 4], keep=2).all_steps() == [3, 4]


def test_checkpoint_ignores_and_collects_tmp_litter(tmp_path):
    """A directory without META.json is not a checkpoint; a save tmp
    (step_XXXXXXXX.tmp_<pid>) is never one, even with a META.json, and a new
    manager removes it."""
    ckpt = _save_steps(tmp_path, [1])
    os.makedirs(tmp_path / "step_00000009")
    tmp = tmp_path / "step_00000010.tmp_12345"
    os.makedirs(tmp)
    (tmp / "META.json").write_text("{}")
    assert ckpt.all_steps() == [1] and ckpt.latest_step() == 1
    CheckpointManager(str(tmp_path), async_save=False)
    assert not tmp.exists()


def test_checkpoint_async_save_copies_before_returning(tmp_path):
    """save() copies every leaf to the host before it returns: the step
    updates params and moments in place, and the writer thread must write
    the values of the step that was saved."""
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    x = torch.full((1 << 16,), 5.0)
    ckpt.save(5, {"x": x, "n": 3})
    x.add_(1.0)  # the next step's in-place update, racing the writer
    ckpt.wait()
    out = ckpt.restore(5, {"x": torch.zeros(1 << 16), "n": 0})
    assert torch.equal(out["x"], torch.full((1 << 16,), 5.0)) and out["n"] == 3


@pytest.mark.parametrize("surface", ["wait", "save"])
def test_async_save_failure_surfaces(tmp_path, monkeypatch, surface):
    """A writer-thread failure does not vanish: the next wait() or save()
    re-raises it, and the manager works again afterwards."""
    ckpt = CheckpointManager(str(tmp_path), async_save=True)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(manager_module.np, "savez", boom)
    ckpt.save(1, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        if surface == "wait":
            ckpt.wait()
        else:
            ckpt.save(2, {"x": torch.ones(2)}, block=True)
    monkeypatch.undo()
    ckpt.save(3, {"x": torch.ones(2)}, block=True)
    assert ckpt.latest_step() == 3


def test_latest_valid_step_walks_past_truncated_npz(tmp_path):
    ckpt = _save_steps(tmp_path, [1, 2, 3])
    npz = tmp_path / "step_00000003" / "host_0.npz"
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)  # a torn write
    assert ckpt.latest_step() == 3 and not ckpt.valid_step(3) and ckpt.valid_step(2)
    assert ckpt.latest_valid_step() == 2
    assert torch.equal(ckpt.restore(2, {"x": torch.zeros(8)})["x"], torch.full((8,), 2.0))


def test_latest_valid_step_skips_unparseable_meta(tmp_path):
    ckpt = _save_steps(tmp_path, [1, 2])
    (tmp_path / "step_00000002" / "META.json").write_text("{ not json")
    assert not ckpt.valid_step(2) and ckpt.latest_valid_step() == 1


def test_checksum_catches_bit_flip_zip_crc_cannot_see(tmp_path):
    """A byte flipped in the npz's central directory leaves the member CRCs
    intact; only the recorded whole-file crc32 (checksum=True) sees it."""
    ckpt = _save_steps(tmp_path, [1, 2], checksum=True)
    assert "checksums" in ckpt.meta(2)
    with open(tmp_path / "step_00000002" / "host_0.npz", "r+b") as f:
        f.seek(-3, os.SEEK_END)
        b = f.read(1)
        f.seek(-3, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    assert not ckpt.valid_step(2) and ckpt.latest_valid_step() == 1


def test_checksum_off_keeps_meta_layout(tmp_path):
    ckpt = _save_steps(tmp_path, [1], checksum=False)
    assert sorted(ckpt.meta(1)) == ["dtypes", "groups", "step", "time"]
    assert ckpt.valid_step(1)  # the zip CRCs still validate


def _npz_bytes(root):
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(root) for f in fs if f.endswith(".npz"))


def _param_tree():
    """Two quantizable weights (≥ MIN_QUANT_SIZE elements; one ragged against
    both blocks) and a small leaf that stays f32, beside an opt leaf."""
    rng = np.random.default_rng(3)
    w = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    return {"params": {"w": w(512, 128), "emb": w(250, 67), "bias": w(64)},
            "opt_state": {"m": w(512, 128)}}


@pytest.mark.parametrize("codec,size_ratio,max_rel", [("int8", 3.0, 0.02), ("int4", 4.0, 0.12)])
def test_quantized_checkpoint_file_codec(tmp_path, codec, size_ratio, max_rel):
    """The file codec's codes and scales are the reference's _np_quantize's
    bit for bit; the files shrink; restore is lossy within the reference's
    bound (the codec is not exact), small and non-params leaves round-trip
    bit for bit, and a second save of the restored tree is lossless."""
    tree = _param_tree()
    for sub, quantize in (("f32", None), (codec + "_params", codec)):
        CheckpointManager(str(tmp_path / sub), async_save=False, quantize=quantize).save(
            1, {"params": tree["params"]}, block=True)
    assert _npz_bytes(tmp_path / "f32") / _npz_bytes(tmp_path / (codec + "_params")) >= size_ratio
    q = CheckpointManager(str(tmp_path / codec), async_save=False, quantize=codec)
    q.save(1, tree, block=True)
    meta = q.meta(1)
    assert set(meta["quant"]) == {"params.w", "params.emb"}
    with np.load(tmp_path / codec / "step_00000001" / "host_0.npz") as z:
        for key in ("params.w", "params.emb"):
            codes, scales = jax_np_quantize(tree["params"][key.split(".")[1]].numpy(), codec)
            assert z[key + "::q"].dtype == codes.dtype
            np.testing.assert_array_equal(z[key + "::q"], codes)
            np.testing.assert_array_equal(z[key + "::scale"], scales)
            assert meta["quant"][key]["crc_q"] == manager_module._crc(codes)
    zeros = tree_map(torch.zeros_like, tree)
    restored = q.restore(1, zeros)
    for k in ("w", "emb"):
        a, b = tree["params"][k], restored["params"][k]
        rel = float((a - b).abs().max() / a.abs().max())
        assert 0 < rel < max_rel, (codec, k, rel)
    assert torch.equal(restored["params"]["bias"], tree["params"]["bias"])
    assert torch.equal(restored["opt_state"]["m"], tree["opt_state"]["m"])
    q2 = CheckpointManager(str(tmp_path / (codec + "_again")), async_save=False, quantize=codec)
    q2.save(1, restored, block=True)
    again = q2.restore(1, zeros)
    for k, v in _flat(restored).items():
        np.testing.assert_array_equal(_flat(again)[k], v, err_msg=k)


@pytest.mark.parametrize("which", ["q", "scale"])
def test_quantized_checkpoint_corruption_detected(tmp_path, which):
    """Codes and scales carry separate crc32s, checked on every restore."""
    ckpt = CheckpointManager(str(tmp_path), async_save=False, quantize="int4")
    ckpt.save(1, _param_tree(), block=True)
    npz = tmp_path / "step_00000001" / "host_0.npz"
    data = dict(np.load(npz))
    arr = data[f"params.w::{which}"].copy()
    arr.view(np.uint8)[:4] ^= 0xFF
    data[f"params.w::{which}"] = arr
    np.savez(npz, **data)
    with pytest.raises(ValueError, match="crc32"):
        ckpt.restore(1, tree_map(torch.zeros_like, _param_tree()))


def test_quantized_checkpoint_missing_codes_rejected(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), async_save=False, quantize="int4")
    ckpt.save(1, _param_tree(), block=True)
    npz = tmp_path / "step_00000001" / "host_0.npz"
    data = dict(np.load(npz))
    del data["params.w::q"]
    np.savez(npz, **data)
    with pytest.raises(KeyError):
        ckpt.restore(1, tree_map(torch.zeros_like, _param_tree()))


@pytest.mark.parametrize("target,error", [
    ({"m": {"q": torch.zeros(4, 256), "scale": torch.zeros(4)}}, "not interchangeable"),
    ({"m": {"q": torch.zeros(2, 256, dtype=torch.uint8), "scale": torch.zeros(2)}}, "shape"),
    ({"m": {"q": torch.zeros(4, 256, dtype=torch.uint8)}, "n": torch.zeros(1)}, "missing"),
])
def test_restore_refuses_layout_mismatch(tmp_path, target, error):
    """int8 codes do not restore into an f32 leaf (the float/integer family
    check), nor into another shape, and a missing leaf is an error."""
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(1, {"m": {"q": torch.zeros(4, 256, dtype=torch.uint8), "scale": torch.ones(4)}},
              block=True)
    with pytest.raises((ValueError, KeyError), match=error):
        ckpt.restore(1, target)


# ---------------------------------------------------------------------------
# 2. the format is the reference's: each state form, both ways
# ---------------------------------------------------------------------------

_G = dict(rank=16, update_freq=10, scale=0.25)
_Q8 = dict(moments="int8", projectors="int4")
FORMS = {
    "adamw": dict(),
    "galore_emit": dict(galore=_G, galore_fused_adam=True),
    "galore_apply": dict(galore=_G, galore_fused_adam=True, galore_fused_apply=True),
    "galore_8bit": dict(optimizer="adam8bit", galore=dict(_G, quant=_Q8), galore_fused_adam=True),
    "adam8bit": dict(optimizer="adam8bit"),
    "adafactor": dict(optimizer="adafactor"),
    "galore_adafactor": dict(optimizer="adafactor", galore=_G),
    "sgd": dict(optimizer="sgd"),
}


def _train_configs(form):
    """(JAX TrainConfig, port TrainConfig) of one state form: AdamW's weight
    decay on, so the chain carries its empty decay state too."""
    kw = dict(FORMS[form])
    g = kw.pop("galore", None)
    common = dict(weight_decay=0.01, lr=1e-3, total_steps=10, warmup_steps=2, **kw)
    jg = tg = None
    if g is not None:
        q = g.get("quant")
        jg = JGaLoreConfig(**dict(g, quant=JQuantPolicy(**q) if q else JQuantPolicy()))
        tg = GaLoreConfig(**dict(g, quant=QuantPolicy(**q) if q else QuantPolicy()))
    return JTrainConfig(galore=jg, **common), TrainConfig(galore=tg, **common)


# the W-in-place step keeps the emit step's state layout, and JAX's apply
# step is its emit step + chain within 2e-5 (tests/test_torch_apply.py), so
# the apply form is held to the emit form's JAX checkpoint and next step
_JAX_FORM = {"galore_apply": "galore_emit"}


def _batch(rng):
    tokens = rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32)
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[:, -1] = 0.0
    return {"tokens": tokens, "targets": np.concatenate([tokens[:, 1:], tokens[:, -1:]], 1),
            "loss_mask": mask}


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Per state form, once: two JAX steps, a JAX checkpoint at step 1, and
    JAX's next step from it (every form starts from the port's initial
    weights and takes the same three numpy batches)."""
    jcfg = jax_get_config("llama_60m", smoke=True)
    rng = np.random.default_rng(0)
    batches = [_batch(rng) for _ in range(3)]
    p0 = TM.init_params(get_config("llama_60m", smoke=True), seed=0, device="cpu")
    jp0 = tree_map(lambda t: jnp.asarray(t.detach().numpy()), p0)
    cache = {}

    def run(form):
        form = _JAX_FORM.get(form, form)
        if form in cache:
            return cache[form]
        root = tmp_path_factory.mktemp(form)
        jtc, _ = _train_configs(form)
        step_fn, jopt = jax_make_train_step(jcfg, jtc)
        step_fn = jax.jit(step_fn)
        init = {"params": jp0, "opt_state": jax.jit(jopt.init)(jp0)}
        jp, js = jp0, init["opt_state"]
        for s in range(2):
            jp, js, _ = step_fn(jp, js, batches[s])
        saved = {"params": jp, "opt_state": js}
        JCheckpointManager(str(root / "jax"), async_save=False).save(1, saved, block=True)
        jp3, _, metrics = step_fn(jp, js, batches[2])
        cache[form] = dict(root=root, init=init, saved=_jflat(saved),
                           batch={k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                                      else v) for k, v in batches[2].items()},
                           next_params=_jflat(jp3), next_loss=float(metrics["loss"]))
        return cache[form]

    return run


def _port_restore(form, root):
    """The port's target tree for `form`, filled from the checkpoint at
    step 1 under root/jax; returns (restored tree, train_step)."""
    _, tc = _train_configs(form)
    cfg = get_config("llama_60m", smoke=True)
    step_fn, opt = make_train_step(cfg, tc)
    params = TM.init_params(cfg, seed=0, device="cpu")
    target = {"params": params, "opt_state": opt.init(params)}
    return CheckpointManager(str(root / "jax"), async_save=False).restore(1, target), step_fn


@pytest.mark.parametrize("form", list(FORMS))
def test_jax_checkpoint_restores_in_port(jax_run, form):
    """Every leaf of a JAX checkpoint lands in the port's state bit for bit,
    in its dtype: int32 step and count, uint32 key, uint8 codes, f32 rest
    (the apply form restores the emit form's checkpoint: one layout)."""
    run = jax_run(form)
    restored, _ = _port_restore(form, run["root"])
    _assert_trees_bitwise(_flat(restored), run["saved"])
    for _, p in tree_leaves_with_path(restored["params"]):
        assert p.requires_grad


@pytest.mark.parametrize("form", list(FORMS))
def test_port_next_step_from_jax_checkpoint(jax_run, form):
    """The port's step from the restored JAX state, on the same batch, lands
    within 2e-5 of JAX's step (loss and every parameter; the apply form's
    W-in-place step against JAX's emit step + chain)."""
    run = jax_run(form)
    restored, step_fn = _port_restore(form, run["root"])
    params, _, metrics = step_fn(restored["params"], restored["opt_state"], run["batch"])
    assert abs(float(metrics["loss"]) - run["next_loss"]) <= 2e-5
    got = _flat(params)
    for k, want in run["next_params"].items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("form", list(FORMS))
def test_port_checkpoint_restores_in_jax(jax_run, form, tmp_path):
    """The port's state after its own step, saved by the port, restores in
    the JAX manager into jopt.init's tree bit for bit, and its npz keys and
    META dtypes are those of the JAX manager's save of the same form."""
    run = jax_run(form)
    restored, step_fn = _port_restore(form, run["root"])
    params, opt_state, _ = step_fn(restored["params"], restored["opt_state"], run["batch"])
    port_tree = {"params": params, "opt_state": opt_state}
    CheckpointManager(str(tmp_path), async_save=False).save(2, port_tree, block=True)
    jrestored = JCheckpointManager(str(tmp_path), async_save=False).restore(2, run["init"])
    _assert_trees_bitwise(_jflat(jrestored), _flat(port_tree))
    jax_meta = json.loads((run["root"] / "jax" / "step_00000001" / "META.json").read_text())
    port_meta = json.loads((tmp_path / "step_00000002" / "META.json").read_text())
    assert port_meta["dtypes"] == jax_meta["dtypes"] and port_meta["groups"] == jax_meta["groups"]
    with np.load(tmp_path / "step_00000002" / "host_0.npz") as z:
        port_keys = sorted(z.files)
    with np.load(run["root"] / "jax" / "step_00000001" / "host_0.npz") as z:
        assert port_keys == sorted(z.files)


def test_legacy_flat_int4_projector_reads():
    """A JAX checkpoint whose projectors are in the reference's older flat
    int4 layout (2-D codes, 1-D scales) still reads: read_projector decodes
    it bit for bit as the reference's dequant4_state does."""
    from repro.core.projector import read_projector as jax_read_projector
    from repro.quant.codec import quant4_state as jax_quant4_state
    from repro_torch.core.projector import read_projector

    rng = np.random.default_rng(5)
    P = rng.standard_normal((2, 64, 16)).astype(np.float32)
    st = jax.jit(jax_quant4_state)(jnp.asarray(P))
    want = np.asarray(jax.jit(jax_read_projector, static_argnums=1)(st, P.shape))
    got = read_projector({k: torch.tensor(np.asarray(v)) for k, v in st.items()}, P.shape)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# 3. resume and preemption through the launcher
# ---------------------------------------------------------------------------


def _loop(ckpt_dir, steps, quant=None, ckpt_every=0, on_step=None):
    tc = TrainConfig(optimizer="adamw", galore=GaLoreConfig(rank=16, update_freq=4,
                                                            quant=quant or QuantPolicy()),
                     galore_fused_adam=True, lr=1e-3, weight_decay=0.01, total_steps=12,
                     warmup_steps=2)
    run = RunConfig(steps=steps, batch_per_host=BATCH, seq_len=SEQ, ckpt_dir=str(ckpt_dir),
                    ckpt_every=ckpt_every, log_every=100, device="cpu")
    return train_loop(run, tc, on_step=on_step)


@pytest.mark.parametrize("quant", [None, QuantPolicy(**_Q8)], ids=["fp32", "8bit"])
def test_resume_is_bitwise(tmp_path, quant):
    """12 straight steps equal 6 steps, a save at step 5, a resume and 6 more
    (with a refresh at step 8, after the resume point), bit for bit: every
    loss, every parameter and every leaf of the optimizer state."""
    straight, resumed = {}, {}
    p1, s1, _, _ = _loop(tmp_path / "straight", 12, quant,
                         on_step=lambda s, m: straight.__setitem__(s, float(m["loss"])))
    _loop(tmp_path / "split", 6, quant, ckpt_every=5)
    assert CheckpointManager(str(tmp_path / "split")).latest_step() == 5
    p2, s2, _, last = _loop(tmp_path / "split", 12, quant, ckpt_every=5,
                            on_step=lambda s, m: resumed.__setitem__(s, float(m["loss"])))
    assert sorted(resumed) == list(range(6, 12)) and last == 11
    assert resumed == {s: straight[s] for s in resumed}
    _assert_trees_bitwise(_flat({"p": p2, "s": s2}), _flat({"p": p1, "s": s1}))


def test_preempt_saves_and_returns(tmp_path):
    """A PREEMPT file in the checkpoint root makes the loop save the step it
    just took (blocking), remove the file and return; the checkpoint records
    the pipeline's position, and the next run resumes after it."""
    flag = tmp_path / "PREEMPT"

    def on_step(step, metrics):
        if step == 3:
            flag.write_text("")

    *_, last = _loop(tmp_path, 12, on_step=on_step)
    assert last == 3 and not flag.exists()
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.all_steps() == [3]
    assert ckpt.meta(3)["data"] == {"step": 3, "seed": 0, "n_hosts": 1}
    seen = []
    _loop(tmp_path, 5, on_step=lambda s, m: seen.append(s))
    assert seen == [4]


# ---------------------------------------------------------------------------
# 4. a refresh in flight: the pending group and the adaptive schedule
# ---------------------------------------------------------------------------

_ASYNC_G = dict(rank=8, update_freq=4, refresh_stagger=True, adaptive_t=True)


def _async_tc(quant=None, steps=12):
    """Fused GaLore with the async, staggered, adaptive-T refresh (8-bit with
    `quant`): every step has a refresh in flight after step 0."""
    g = GaLoreConfig(**_ASYNC_G, reproject_moments=True,
                     quant=QuantPolicy(**quant) if quant else QuantPolicy())
    return TrainConfig(optimizer="adam8bit" if quant else "adamw", galore=g,
                       galore_refresh_async=True, galore_fused_adam=True, lr=1e-3,
                       weight_decay=0.01, total_steps=steps, warmup_steps=2)


def _async_loop(ckpt_dir, steps, quant=None, ckpt_every=0, on_step=None, **kw):
    run = RunConfig(steps=steps, batch_per_host=BATCH, seq_len=SEQ, ckpt_dir=str(ckpt_dir),
                    ckpt_every=ckpt_every, log_every=100, device="cpu")
    return train_loop(run, _async_tc(quant), on_step=on_step, **kw)


@pytest.mark.parametrize("quant", [None, _Q8], ids=["fp32", "8bit"])
def test_async_resume_lands_the_same_swap(tmp_path, quant):
    """12 straight async steps equal 6 steps with a save at step 5 (a
    refresh in flight: the checkpoint holds its pending group and the
    adaptive schedule) and a resume for 6 more, bit for bit: the resumed
    run re-arms the pending buffer and its stale batch (prime_stale) and
    swaps it in at step 6, as the straight run does."""
    straight, resumed = {}, {}
    p1, s1, _, _ = _async_loop(tmp_path / "straight", 12, quant,
                               on_step=lambda s, m: straight.__setitem__(s, float(m["loss"])))
    _async_loop(tmp_path / "split", 6, quant, ckpt_every=5)
    ckpt = CheckpointManager(str(tmp_path / "split"))
    assert ckpt.groups(5) == ("opt_state", "params", "pending")
    with np.load(tmp_path / "split" / "step_00000005" / "host_0.npz") as z:
        assert "pending.flag.blocks.attn.wq" in z.files
        assert "opt_state.1.schedule.next.blocks.ffn.down" in z.files
        assert "pending.schedule.period.blocks.ffn.up" in z.files
    p2, s2, _, _ = _async_loop(tmp_path / "split", 12, quant, ckpt_every=5,
                               on_step=lambda s, m: resumed.__setitem__(s, float(m["loss"])))
    assert sorted(resumed) == list(range(6, 12))
    assert resumed == {s: straight[s] for s in resumed}
    _assert_trees_bitwise(_flat({"p": p2, "s": s2}), _flat({"p": p1, "s": s1}))


def _jax_async_run(root, steps, save_at):
    """The reference's AsyncRefreshDriver and train step on one device (its
    launcher's host mesh refuses its sharding constraints on the CPU:
    ROADMAP C.4), from the port's initial weights, saving {params,
    opt_state, pending} after step `save_at` as its launcher does; returns
    (losses, JAX data pipeline, JAX optimizer, model config, TrainConfig)."""
    from repro.data.pipeline import DataConfig as JDataConfig
    from repro.data.pipeline import SyntheticC4 as JSyntheticC4
    from repro.launch.train import AsyncRefreshDriver as JAsyncRefreshDriver

    jcfg = jax_get_config("llama_60m", smoke=True)
    jtc = JTrainConfig(optimizer="adamw", galore=JGaLoreConfig(**_ASYNC_G, reproject_moments=True),
                       galore_refresh_async=True, galore_fused_adam=True, lr=1e-3,
                       weight_decay=0.01, total_steps=12, warmup_steps=2)
    step_fn, jopt = jax_make_train_step(jcfg, jtc)
    step_fn = jax.jit(step_fn)
    p0 = TM.init_params(get_config("llama_60m", smoke=True), seed=0, device="cpu")
    jp = tree_map(lambda t: jnp.asarray(t.detach().numpy()), p0)
    js = jopt.init(jp)
    driver = JAsyncRefreshDriver(jcfg, jtc, None)
    jdata = JSyntheticC4(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=SEQ,
                                     batch_per_host=BATCH))
    losses = []
    for s in range(steps):
        b = jdata.batch(s)
        js = driver.maybe_refresh(jp, js, b, s)
        jp, js, metrics = step_fn(jp, js, b)
        losses.append(float(metrics["loss"]))
        if s == save_at:
            assert driver.pending is not None
            JCheckpointManager(str(root), async_save=False).save(
                s, {"params": jp, "opt_state": js, "pending": driver.pending}, block=True)
    return losses, jdata, jopt, jcfg, jtc


class _JBatches:
    """The JAX pipeline's batches as CPU tensors."""

    def __init__(self, jdata):
        self.jdata = jdata

    def batch(self, step):
        b = self.jdata.batch(step)
        return {k: torch.from_numpy(np.array(v).astype(np.int64) if k != "loss_mask"
                                    else np.array(v)) for k, v in b.items()}


def test_jax_pending_checkpoint_resumes_in_port(tmp_path):
    """A checkpoint the reference's driver wrote with a refresh in flight
    (pending group, adaptive schedule) restores in the port bit for bit,
    and the port's run resumed from it — the pending buffer swapped in at
    the next step, its stale batch primed — follows the JAX run within
    5e-2 to step 9."""
    want, jdata, jopt, _, jtc = _jax_async_run(tmp_path / "jax", 10, save_at=4)
    assert set(JCheckpointManager(str(tmp_path / "jax")).groups(4)) == {
        "opt_state", "params", "pending"}
    cfg = get_config("llama_60m", smoke=True)
    tc = _async_tc()
    _, opt = make_train_step(cfg, tc)
    params = TM.init_params(cfg, seed=0, device="cpu")
    from repro_torch.core.galore import init_pending_state

    target = {"params": params, "opt_state": opt.init(params),
              "pending": init_pending_state(params, tc.galore)}
    restored = CheckpointManager(str(tmp_path / "jax"), async_save=False).restore(4, target)
    with np.load(tmp_path / "jax" / "step_00000004" / "host_0.npz") as z:
        saved = {k: z[k] for k in z.files}
    got = _flat(restored)
    assert sorted(got) == sorted(saved)
    for k, w in saved.items():
        np.testing.assert_array_equal(got[k].astype(w.dtype), w, err_msg=k)
    assert isinstance(restored["opt_state"][1]["schedule"]["next"]["blocks"]["attn"]["wq"], int)
    got_losses = {}
    train_loop(RunConfig(steps=10, batch_per_host=BATCH, seq_len=SEQ, log_every=100,
                         ckpt_every=0, ckpt_dir=str(tmp_path / "jax"), device="cpu"),
               tc, cfg=cfg, data=_JBatches(jdata),
               on_step=lambda s, m: got_losses.__setitem__(s, float(m["loss"])))
    assert sorted(got_losses) == list(range(5, 10))
    np.testing.assert_allclose([got_losses[s] for s in range(5, 10)], want[5:], rtol=0,
                               atol=5e-2)


def test_port_pending_checkpoint_restores_in_jax(tmp_path):
    """A port checkpoint taken with a refresh in flight restores in the JAX
    manager into the reference's {params, opt_state, pending} tree bit for
    bit (int32 schedule and flags, f32 overlap and projectors)."""
    from repro.core.galore import init_pending_state as jax_init_pending_state

    _async_loop(tmp_path, 3, ckpt_every=2)
    port_ckpt = CheckpointManager(str(tmp_path), async_save=False)
    assert port_ckpt.groups(2) == ("opt_state", "params", "pending")
    jcfg = jax_get_config("llama_60m", smoke=True)
    jtc = JTrainConfig(optimizer="adamw", galore=JGaLoreConfig(**_ASYNC_G, reproject_moments=True),
                       galore_refresh_async=True, galore_fused_adam=True, weight_decay=0.01)
    _, jopt = jax_make_train_step(jcfg, jtc)
    p0 = TM.init_params(get_config("llama_60m", smoke=True), seed=0, device="cpu")
    jp0 = tree_map(lambda t: jnp.asarray(t.detach().numpy()), p0)
    jtarget = {"params": jp0, "opt_state": jopt.init(jp0),
               "pending": jax_init_pending_state(jp0, jtc.galore)}
    jrestored = JCheckpointManager(str(tmp_path), async_save=False).restore(2, jtarget)
    with np.load(tmp_path / "step_00000002" / "host_0.npz") as z:
        saved = {k: z[k] for k in z.files}
    got = _jflat(jrestored)
    assert sorted(got) == sorted(saved)
    meta = json.loads((tmp_path / "step_00000002" / "META.json").read_text())
    for k, w in saved.items():
        assert got[k].dtype.name == meta["dtypes"][k], k
        np.testing.assert_array_equal(got[k].astype(w.dtype), w, err_msg=k)
    assert meta["dtypes"]["pending.flag.blocks.attn.wq"] == "int32"
    assert meta["dtypes"]["opt_state.1.schedule.overlap.blocks.attn.wq"] == "float32"
