"""The port's 8-bit Adam baseline (``--optimizer adam8bit`` without GaLore)
against the JAX package on the same inputs: the flat INT8 codec bit for bit,
the flat 8-bit Adam step against the Pallas kernel in interpret mode and
against ``ref.adam8bit_update``, ``scale_by_adam8bit`` over three steps, a
20-step trajectory, the state's bytes and its bridge, and the CLI."""
import os
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticC4 as JSyntheticC4  # noqa: E402
from repro.distributed.step import make_train_step as jax_make_train_step  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adam8bit import scale_by_adam8bit as jax_scale_by_adam8bit  # noqa: E402
from repro.quant import codec as jcodec  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    params_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.configs.base import GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.kernels import adam8bit_update as a8  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.train import RunConfig, train_loop  # noqa: E402
from repro_torch.optim.adam8bit import adam8bit_state_bytes, scale_by_adam8bit  # noqa: E402
from repro_torch.optim.factory import build_optimizer  # noqa: E402
from repro_torch.quant import codec  # noqa: E402
from repro_torch.utils import tree_leaves, tree_leaves_with_path, tree_map  # noqa: E402
from test_torch_cuda import assert_codes_close, flat_inputs  # noqa: E402
from test_torch_quant import _assert_bitwise, _assert_close  # noqa: E402
from test_torch_train import _Bridged  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_PATH = pathlib.Path(ROOT)
COUNT = 7


def _count():
    return torch.tensor(COUNT, dtype=torch.int32)


# ---------------------------------------------------------------------------
# 1. the flat codec, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(700,), (3, 100), (256,), (5, 1000)])
@pytest.mark.parametrize("signed", [True, False])
def test_flat_codec_matches(shape, signed):
    """Codes, scales and the dequant of JAX's quant/codec.py, for leaves with
    numel % 256 != 0 and with whole blocks of zeros."""
    x = (np.random.default_rng(sum(shape)).standard_normal(shape) * 3.0).astype(np.float32)
    x.reshape(-1)[:256] = 0.0  # an all-zero block
    if not signed:
        x = np.abs(x)
    jq, js = jcodec.quantize(jnp.asarray(x), signed)
    tq, ts = codec.quantize(torch.from_numpy(x), signed)
    _assert_bitwise(tq, jq, "codes")
    _assert_bitwise(ts, js, "scales")
    _assert_bitwise(codec.dequantize(tq, ts, shape, signed),
                    jcodec.dequantize(jq, js, shape, signed), "dequant")
    st = codec.quant_state(torch.from_numpy(x), signed)
    _assert_bitwise(codec.dequant_state(st, shape, signed),
                    jcodec.dequant_state(jcodec.quant_state(jnp.asarray(x), signed), shape,
                                         signed), "state")


# ---------------------------------------------------------------------------
# 1b. the bracket tables the flat kernel finds its nearest codes in
# ---------------------------------------------------------------------------


def _bracket_key(x, signed):
    """The kernel's bucket of each f32 value (bracket_code in
    csrc/galore_epilogue.cu): sign, exponent clamped to [lo, hi] and the top
    `bits` mantissa bits; the unsigned book's negatives go to bucket 0."""
    lo, hi, bits = codec.BRACKETS[signed]
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = u >> 31
    mag = u & 0x7FFFFFFF
    if not signed:
        mag = torch.where(neg == 1, torch.zeros_like(mag), mag)
    key = torch.clamp(mag >> (23 - bits), lo << bits, ((hi + 1) << bits) - 1) - (lo << bits)
    return key + neg * ((hi - lo + 1) << bits) if signed else key


def _mids(signed):
    return codec._mids(torch.from_numpy(codec.dynamic_codebook(signed)))


def _bracket_codes(x, signed):
    """A plain-PyTorch emulation of the kernel's lookup, through the very
    tensor the kernel reads (codec.device_code_tables): the table's count of
    midpoints below x's bucket, plus one comparison with the next midpoint
    (the kernel pads the midpoints with +inf)."""
    tables = codec.device_code_tables(torch.device("cpu")).to(torch.int64)
    n_signed = codec.bracket_table(True).size
    table = tables[:n_signed] if signed else tables[n_signed:]
    mids = torch.cat([_mids(signed), torch.tensor([float("inf")])])
    below = table[_bracket_key(x, signed)]
    return below + (mids[below] < x).to(torch.int64)


def _assert_searchsorted(x, signed, what):
    want = torch.searchsorted(_mids(signed), x.contiguous())
    got = _bracket_codes(x, signed)
    bad = (got != want).nonzero().reshape(-1)
    assert bad.numel() == 0, (what, x[bad[:5]].tolist(), got[bad[:5]].tolist(),
                              want[bad[:5]].tolist())


@pytest.mark.parametrize("signed", [True, False])
def test_bracket_table_gives_searchsorted_at_every_edge(signed):
    """Every midpoint and its neighbours 1 and 2 f32 ulps either side, ±0,
    ±1, ±inf, the smallest non-zero midpoints and values below them (down to
    the smallest subnormal), and every bucket's edges: the lookup's code is
    searchsorted(mids, x) bit for bit."""
    mids = _mids(signed)
    up, down = torch.tensor(float("inf")), torch.tensor(float("-inf"))
    near = [mids]
    for toward in (up, down):
        once = torch.nextafter(mids, toward)
        near += [once, torch.nextafter(once, toward)]
    least = mids[mids > 0].min()
    small = torch.tensor([least / 2, least / 1e3, 1e-30, 1e-38, 1e-45, 0.0, -0.0, 1.0, -1.0,
                          float("inf"), float("-inf")], dtype=torch.float32)
    neg_least = mids[mids < 0].max() if signed else least
    small = torch.cat([small, -small, torch.stack([least, neg_least, -least])])
    lo, hi, bits = codec.BRACKETS[signed]
    edge_bits = torch.arange(lo << bits, (hi + 1) << bits, dtype=torch.int64) << (23 - bits)
    edges = edge_bits.to(torch.int32).view(torch.float32)
    edges = torch.cat([edges, torch.nextafter(edges, down), torch.nextafter(edges, up)])
    edges = torch.cat([edges, -edges])
    for what, x in (("midpoints ± 2 ulps", torch.cat(near)), ("small and special", small),
                    ("bucket edges", edges)):
        _assert_searchsorted(x, signed, what)


@pytest.mark.parametrize("signed", [True, False])
def test_bracket_table_gives_the_codecs_codes_on_normed_blocks(signed):
    """10⁶ seeded values x / (max|x| + 1e-12) over 256-element blocks of
    normal draws (squared for the unsigned book, as V is): the lookup's codes
    equal searchsorted's and JAX's codec's (jcodec.quantize) bit for bit."""
    rng = np.random.default_rng(29 if signed else 31)
    x = rng.standard_normal((4096, codec.BLOCK), np.float32)
    x = x if signed else x * x
    jq, _ = jcodec.quantize(jnp.asarray(x), signed)
    blocks = torch.from_numpy(x)
    normed = blocks / (torch.amax(blocks.abs(), dim=1, keepdim=True) + 1e-12)
    _assert_searchsorted(normed.reshape(-1), signed, "normed blocks")
    got = _bracket_codes(normed.reshape(-1), signed).to(torch.uint8).view(x.shape)
    _assert_bitwise(got, jq, "codes")


@pytest.mark.parametrize("signed", [True, False])
def test_bracket_buckets_hold_at_most_one_midpoint(signed):
    """The kernel compares x with one midpoint past its bucket's entry, so no
    bucket may hold two: counted here from each midpoint's own bucket, not
    by codec.bracket_table. The table spans the kernel's key range (a row
    of buckets for each sign of the signed book), and its entries grow with
    the bucket."""
    lo, hi, bits = codec.BRACKETS[signed]
    rows = (2 if signed else 1) * ((hi - lo + 1) << bits)
    table = codec.bracket_table(signed)
    assert table.dtype == np.uint8 and table.shape == (rows,)
    positives = table[:(hi - lo + 1) << bits]
    assert np.all(np.diff(positives.astype(np.int32)) >= 0)  # larger buckets, more below
    per_bucket = torch.bincount(_bracket_key(_mids(signed), signed), minlength=rows)
    assert int(per_bucket.max()) == 1, int(per_bucket.max())


def test_bracket_tables_match_the_kernel_source():
    """codec.BRACKETS and the kernel's Bracket<true> / Bracket<false> hold the
    same exponent ranges and mantissa bits, and device_code_tables is the
    signed table then the unsigned one, kTables bytes (a multiple of 16, as
    the kernel copies it in 16-byte words), made once per device."""
    src = (ROOT_PATH / "src" / "repro_torch" / "csrc" / "galore_epilogue.cu").read_text()
    found = dict(re.findall(r"struct Bracket<(true|false)> \{ static constexpr int "
                            r"(lo = \d+, hi = \d+, bits = \d+); \}", src))
    for signed in (True, False):
        lo, hi, bits = codec.BRACKETS[signed]
        assert found[str(signed).lower()] == f"lo = {lo}, hi = {hi}, bits = {bits}"
    tables = codec.device_code_tables(torch.device("cpu"))
    assert tables is codec.device_code_tables(torch.device("cpu"))
    assert tables.dtype == torch.uint8 and tables.numel() % 16 == 0
    np.testing.assert_array_equal(tables.numpy(), np.concatenate(
        [codec.bracket_table(True), codec.bracket_table(False)]))


# ---------------------------------------------------------------------------
# 2. the flat 8-bit Adam step
# ---------------------------------------------------------------------------


def _blocks(numel):
    g, moments = flat_inputs(numel)
    return g.reshape(-1, codec.BLOCK), moments


@pytest.mark.parametrize("nblocks", [1, 3, 16, 33])
def test_adam8bit_step_matches_pallas_interpret(nblocks):
    """The plain step (the wrapper on CPU tensors) against JAX's
    ops.adam8bit_step through the Pallas kernel in interpret mode, within
    tests/test_kernels.py's bounds: update rtol 1e-4 / atol 1e-6, codes at
    most one apart (the Pallas body rounds a value on a midpoint up, the
    codec down)."""
    g, moments = _blocks(nblocks * codec.BLOCK)
    want = jops.adam8bit_step(jnp.asarray(g), *map(jnp.asarray, moments), jnp.int32(COUNT),
                              use_pallas=True, interpret=True)
    mine = [torch.from_numpy(t.copy()) for t in moments]
    got = ops.adam8bit_step(torch.from_numpy(g), *mine, _count())
    assert all(a is b for a, b in zip(got[1:], mine))  # codes and scales updated in place
    for name, a, b in zip(["update", "mq", "ms", "vq", "vs"], got, want):
        if a.dtype == torch.uint8:
            assert_codes_close(a, b, name)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("nblocks", [1, 33])
def test_adam8bit_step_codes_match_ref(nblocks):
    """Against JAX's ref.adam8bit_update (the same searchsorted midpoint rule):
    codes and scales bit for bit, the update within 1e-5·max."""
    g, moments = _blocks(nblocks * codec.BLOCK)
    books = [jnp.asarray(jcodec.dynamic_codebook(s)) for s in (True, False)]
    want = jref.adam8bit_update(jnp.asarray(g), *map(jnp.asarray, moments), jnp.int32(COUNT),
                                *books)
    got = a8.adam8bit_update_plain(torch.from_numpy(g), *map(torch.from_numpy, moments),
                                   _count())
    _assert_close(got[0], want[0], "update")
    for name, a, b in zip(["mq", "ms", "vq", "vs"], got[1:], want[1:]):
        _assert_bitwise(a, b, name)


def test_ragged_leaf_masks_its_tail():
    """A leaf of 700 elements: the step on the leaf itself equals the step on
    its zero-padded blocks, and leaves the tail's moments at exactly 0."""
    g, moments = flat_inputs(700)
    padded = np.zeros(3 * codec.BLOCK, np.float32)
    padded[:700] = g
    got = a8.adam8bit_update_plain(torch.from_numpy(g).view(7, 100),
                                   *map(torch.from_numpy, moments), _count())
    want = a8.adam8bit_update_plain(torch.from_numpy(padded), *map(torch.from_numpy, moments),
                                    _count())
    assert got[0].shape == (7, 100)
    _assert_bitwise(got[0].reshape(-1), want[0][:700], "update")
    for name, a, b in zip(["mq", "ms", "vq", "vs"], got[1:], want[1:]):
        _assert_bitwise(a, b, name)
    tail = codec.dequantize(got[1], got[2], (3 * codec.BLOCK,))[700:]
    assert not tail.any()


# ---------------------------------------------------------------------------
# 3. scale_by_adam8bit
# ---------------------------------------------------------------------------

PARAM_SHAPES = {"big": (65, 67), "small": (8, 8), "whole": (64, 64)}


def test_scale_by_adam8bit_matches_jax():
    """Three steps from a zero state: every update within 1e-5·max of JAX's
    scale_by_adam8bit, quantized codes at most one apart (their two f32 Adam
    compositions may round a value to either side of a midpoint), scales and
    fp32 moments within 1e-5."""
    rng = np.random.default_rng(5)
    params = {k: np.zeros(s, np.float32) for k, s in PARAM_SHAPES.items()}
    jopt, opt = jax_scale_by_adam8bit(), scale_by_adam8bit()
    jstate = jopt.init(jax.tree_util.tree_map(jnp.asarray, params))
    state = opt.init(tree_map(torch.from_numpy, params))
    for _ in range(3):
        grads = {k: (rng.standard_normal(s) * 0.01).astype(np.float32)
                 for k, s in PARAM_SHAPES.items()}
        jupd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate)
        upd, state = opt.update(tree_map(torch.from_numpy, grads), state)
        for k in PARAM_SHAPES:
            _assert_close(upd[k], jupd[k], f"update {k}")
    want = dict(tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jstate)))
    for path, x in tree_leaves_with_path(state):
        if x.dtype == torch.uint8:
            assert_codes_close(x, want[path], path)
        else:
            _assert_close(x, want[path], path)
    assert int(state["count"]) == 3


def test_adam8bit_small_leaves_stay_fp32():
    """tests/test_optimizers.py's decision: a leaf under 4096 elements keeps
    fp32 moments, one at or above it gets uint8 codes and f32 scales — the
    layout of JAX's state leaf for leaf."""
    params = {"small": np.zeros((8, 8), np.float32), "big": np.zeros((128, 128), np.float32)}
    st = scale_by_adam8bit().init(tree_map(torch.from_numpy, params))
    jst = jax_scale_by_adam8bit().init(jax.tree_util.tree_map(jnp.asarray, params))
    assert st["mv"]["small"]["m"].dtype == torch.float32
    assert st["mv"]["big"]["m"]["q"].dtype == torch.uint8
    got = {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in tree_leaves_with_path(st)}
    want = {p: (tuple(x.shape), np.asarray(x).dtype.name)
            for p, x in tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, jst))}
    assert got == want
    measured = sum(x.numel() * x.element_size() for x in tree_leaves(st["mv"]))
    assert measured == adam8bit_state_bytes(params) == 2 * (64 * 256 + 64 * 4) + 8 * 64


def test_factory_routes_adam8bit_and_refuses_the_unported():
    """optimizer="adam8bit" without GaLore is the 8-bit Adam baseline (its
    state in the chain); adafactor and sgd build too (with GaLore around
    them, its composable path), and a name the reference's factory does
    not know is refused with its ValueError."""
    params = {"w": torch.zeros(64, 64)}
    state = build_optimizer(TrainConfig(optimizer="adam8bit")).init(params)
    assert codec.is_qstate(state[1]["mv"]["w"]["m"])
    for name in ("adafactor", "sgd"):
        build_optimizer(TrainConfig(optimizer=name)).init(params)
        state = build_optimizer(TrainConfig(optimizer=name, galore=GaLoreConfig(rank=4))).init(
            params)
        assert state[1]["proj"]["w"].shape == (64, 4)
    for galore in (None, GaLoreConfig(rank=4)):
        with pytest.raises(ValueError, match="unknown optimizer"):
            build_optimizer(TrainConfig(optimizer="lion", galore=galore))


# ---------------------------------------------------------------------------
# 4. training, the bridge, the CLI
# ---------------------------------------------------------------------------


def test_adam8bit_trajectory_matches_jax(tmp_path):
    """20 steps of the 8-bit Adam baseline on the llama_60m smoke config from
    the JAX package's weights and batches: per-step losses within 5e-2 of
    JAX's run."""
    steps, batch, seq = 20, 4, 64
    jcfg = jax_get_config("llama_60m", smoke=True)
    jtc = JTrainConfig(optimizer="adam8bit", total_steps=steps, warmup_steps=2)
    jdata = JSyntheticC4(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=seq, batch_per_host=batch))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    step_fn, jopt = jax_make_train_step(jcfg, jtc)
    step_fn = jax.jit(step_fn)
    jstate = jopt.init(jparams)
    want = []
    for s in range(steps):
        jparams, jstate, metrics = step_fn(jparams, jstate, jdata.batch(s))
        want.append(float(metrics["loss"]))

    got = []
    tc = TrainConfig(optimizer="adam8bit", total_steps=steps, warmup_steps=2)
    _, opt_state, _, _ = train_loop(
        RunConfig(steps=steps, batch_per_host=batch, seq_len=seq, log_every=steps,
                  ckpt_dir=str(tmp_path), device="cpu"),
        tc, cfg=get_config("llama_60m", smoke=True), params=tparams, data=_Bridged(jdata),
        on_step=lambda s, m: got.append(float(m["loss"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)
    assert want[-1] < want[0]
    assert any(x.dtype == torch.uint8 for x in tree_leaves(opt_state[1]["mv"]))


def test_bridge_round_trips_adam8bit_state():
    """A JAX 8-bit Adam state after one step (uint8 codes, f32 scales, fp32
    small leaves, the count) crosses to the port and back bit for bit."""
    params = {k: jnp.zeros(s) for k, s in PARAM_SHAPES.items()}
    grads = {k: jnp.asarray((np.random.default_rng(7).standard_normal(s) * 0.01)
                            .astype(np.float32)) for k, s in PARAM_SHAPES.items()}
    jopt = jax_scale_by_adam8bit()
    _, jstate = jopt.update(grads, jopt.init(params))
    jnp_state = jax.tree_util.tree_map(np.asarray, jstate)
    state = state_from_numpy(jnp_state, "cpu")
    assert state["mv"]["big"]["v"]["q"].dtype == torch.uint8
    assert state["count"].dtype == torch.int32
    back = dict(tree_leaves_with_path(state_to_numpy(state)))
    want = dict(tree_leaves_with_path(jnp_state))
    assert sorted(back) == sorted(want)
    for path in want:
        _assert_bitwise(back[path], want[path], path)


def test_cli_trains_adam8bit_on_cpu_and_refuses_without_gpu(tmp_path, capsys, monkeypatch):
    cli = ["--steps", "3", "--seq", "32", "--batch", "2", "--optimizer", "adam8bit",
           "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    rc, out, err = _main_in_process(cli + ["--device", "cpu"], capsys)
    assert rc == 0, err
    losses = [float(line.split()[4]) for line in out.splitlines()
              if line.startswith("[train] step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    rc, _, err = _main_in_process(cli, capsys, monkeypatch)
    assert rc == 2 and "no CUDA device" in err

def _main_in_process(argv, capsys, monkeypatch=None):
    """The launcher's main in process (a subprocess would spend its time
    importing torch): (exit code, stdout, stderr). With `monkeypatch` the
    process sees no CUDA device, as a CPU-only host."""
    from repro_torch.launch import train as launcher

    if monkeypatch is not None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        launcher.main(argv)
        rc = 0
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err
