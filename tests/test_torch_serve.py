"""Port serving engine against the JAX package: the allocator and request API,
the contiguous and paged prefill/decode steps, the continuous-batching Engine
(greedy, under preemption, sampled), the padded-chunk clamp the port does not
copy (ROADMAP C.11), checkpoint loading and the CLI — on the llama_60m smoke
config (f32, 2 layers), from JAX's initial weights handed across as numpy."""
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.distributed import step as jstep  # noqa: E402
from repro.launch import serve as jlaunch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.distributed import step as tstep  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    BlockAllocator,
    Completion,
    Engine,
    OutOfBlocks,
    Request,
    ServeConfig,
    generate_batch,
    kv_cache,
)
from torch_threads import one_thread  # noqa: E402,F401

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # optional dependency
    HAVE_HYPOTHESIS = False


def _close(got, want, name, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()), 1e-6), (name, err)


@pytest.fixture(scope="module")
def model():
    """(port cfg, port params, JAX cfg, JAX params): JAX's init, handed across."""
    jcfg = jax_get_config("llama_60m", smoke=True)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    params = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return get_config("llama_60m", smoke=True), params, jcfg, jparams


@pytest.fixture(scope="module")
def jax_engine(model):
    """One JAX Engine per ServeConfig for the whole module (each compiles its
    own jitted steps); a drained engine is reused."""
    _, _, jcfg, jparams = model
    engines = {}

    def get(scfg: ServeConfig):
        key = tuple(scfg.__dict__[f] for f in ("block_size", "num_blocks", "slots",
                                               "max_len_cap", "prefill_chunk"))
        if key not in engines:
            engines[key] = jserve.Engine(jcfg, jparams, jserve.ServeConfig(*key))
        return engines[key]

    return get


def _jax_run(eng, reqs):
    ids = [eng.submit(jserve.Request(tokens=r.tokens, max_new=r.max_new, max_len=r.max_len,
                                     temperature=r.temperature, top_k=r.top_k, seed=r.seed))
           for r in reqs]
    before = eng.stats["preemptions"]
    eng.run_until_drained(timeout_s=300)
    return [eng.result(i) for i in ids], eng.stats["preemptions"] - before


def _port_run(cfg, params, scfg, reqs):
    eng = Engine(cfg, params, scfg)
    ids = [eng.submit(r) for r in reqs]
    eng.run_until_drained(timeout_s=300)
    eng.alloc.check_invariants()
    assert eng.alloc.num_free == scfg.num_blocks - 1  # every block back
    return [eng.result(i) for i in ids], eng


def _rollout(cfg, params, prompt, n):
    """Greedy full-forward rollout (no cache): the engine's acceptance bar."""
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = TM.forward(cfg, params, {"tokens": torch.tensor([toks])})
            toks.append(int(logits[0, -1].argmax()))
    return toks[len(prompt):]


# ---------------------------------------------------------------------------
# BlockAllocator and the request API (the reference's tests on the port's copies)
# ---------------------------------------------------------------------------


def _alloc_reuse():
    a = BlockAllocator(num_blocks=9, block_size=4, blocks_per_table=8)
    assert a.num_free == 8  # block 0 reserved
    a.ensure(1, 10)  # 10 tokens -> 3 blocks
    a.advance(1, 10)
    assert len(a.owned(1)) == 3 and a.length(1) == 10
    a.ensure(1, 2)  # 12 tokens still fit 3 blocks
    assert len(a.owned(1)) == 3
    a.ensure(1, 3)  # 13 tokens -> 4th block
    assert len(a.owned(1)) == 4 and a.num_free == 4
    first_owned = set(a.owned(1))
    assert 0 not in first_owned
    a.check_invariants()
    freed = a.release(1)
    assert freed == 4 and a.num_free == 8 and a.owned(1) == []
    a.ensure(2, 1)  # LIFO: released blocks are immediately reusable
    assert set(a.owned(2)) <= first_owned
    a.check_invariants()


def _alloc_all_or_nothing():
    a = BlockAllocator(num_blocks=5, block_size=2, blocks_per_table=8)
    a.ensure(1, 5)  # 3 of 4 blocks
    a.advance(1, 5)
    free_before = a.num_free
    with pytest.raises(OutOfBlocks):
        a.ensure(2, 6)  # needs 3, only 1 free
    assert a.num_free == free_before and a.owned(2) == []  # nothing leaked
    with pytest.raises(OutOfBlocks):
        a.ensure(3, 100)  # wider than blocks_per_table
    a.check_invariants()


def _alloc_scratch_tail():
    a = BlockAllocator(num_blocks=16, block_size=4, blocks_per_table=6)
    a.ensure(7, 9)
    row = a.table_row(7)
    assert row.shape == (6,) and row.dtype == np.int32
    assert (row[:3] > 0).all() and (row[3:] == 0).all()  # tail -> scratch
    assert a.table_row(999).tolist() == [0] * 6  # unknown request: all scratch


def _request_validation():
    with pytest.raises(ValueError):
        Request(tokens=())
    with pytest.raises(ValueError):
        Request(tokens=(1, 2, 3), max_len=3)  # no room to generate
    with pytest.raises(ValueError):
        Request(tokens=(1,), max_new=0)
    with pytest.raises(ValueError):
        ServeConfig(num_blocks=1)  # needs scratch + >= 1 usable block
    with pytest.raises(ValueError):
        ServeConfig(prefill_chunk=0)
    r = Request(tokens=[torch.tensor(4), np.int64(2)])
    assert r.tokens == (4, 2)  # coerced to plain ints
    assert ServeConfig(block_size=16, max_len_cap=500).blocks_per_table == 32


def _completion_timing():
    c = Completion(request_id=1, prompt_len=3, tokens=(4,), finish_reason="max_new",
                   submitted_at=1.0, first_token_at=1.5, finished_at=3.0)
    assert c.ttft_s == 0.5 and c.latency_s == 2.0


@pytest.mark.parametrize("case", [_alloc_reuse, _alloc_all_or_nothing, _alloc_scratch_tail,
                                  _request_validation, _completion_timing],
                         ids=lambda f: f.__name__.strip("_"))
def test_allocator_and_api(case):
    case()


def _fragmentation_ops(alloc, ops):
    """Interleaved grow/release schedule; invariants must hold throughout."""
    live = set()
    for rid, grow in ops:
        if grow > 0:
            try:
                alloc.ensure(rid, grow)
                alloc.advance(rid, grow)
                live.add(rid)
            except OutOfBlocks:
                pass  # pool pressure is part of the schedule
        elif rid in live:
            alloc.release(rid)
            live.discard(rid)
        alloc.check_invariants()
    for rid in live:
        alloc.release(rid)
    alloc.check_invariants()
    assert alloc.num_free == alloc.num_blocks - 1  # nothing lost to fragmentation


if HAVE_HYPOTHESIS:

    @settings(max_examples=15, deadline=None)
    @given(st.lists(st.tuples(st.integers(0, 5), st.integers(-1, 9)), min_size=1, max_size=60))
    def test_block_table_fragmentation_property(ops):
        _fragmentation_ops(BlockAllocator(12, 3, 7), ops)

else:

    @pytest.mark.parametrize("seed", range(5))
    def test_block_table_fragmentation_property(seed):
        rng = np.random.default_rng(seed)
        ops = [(int(rng.integers(0, 6)), int(rng.integers(-1, 10))) for _ in range(60)]
        _fragmentation_ops(BlockAllocator(12, 3, 7), ops)


@pytest.mark.parametrize("arch", ["llama_60m", "llama_7b"])
def test_pool_bytes_count_the_pool_dtype(arch):
    """pool_bytes / slot_cache_bytes are the allocated tensors' bytes: the
    model's dtype (bf16 for llama_7b), where the reference counts 4 bytes an
    element whatever the dtype (ROADMAP C.11)."""
    cfg = get_config(arch, smoke=True)
    kv = TM.init_paged_cache(cfg, 5, 4, device="cpu")
    assert kv_cache.pool_bytes(cfg, 5, 4) == sum(t.nbytes for t in kv.values())
    cache = TM.init_cache(cfg, 2, 12, device="cpu")
    assert kv_cache.slot_cache_bytes(cfg, 2, 12) == sum(t.nbytes for t in cache.values())
    itemsize = kv["kp"].element_size()
    want_ref = jkv.pool_bytes(jax_get_config(arch, smoke=True), 5, 4)
    assert kv_cache.pool_bytes(cfg, 5, 4) * 4 == want_ref * itemsize
    assert all(float(t.abs().max()) == 0.0 for t in kv.values())  # zeroed, never empty


# ---------------------------------------------------------------------------
# the steps against JAX's on the same inputs
# ---------------------------------------------------------------------------


def test_contiguous_steps_match_jax(model):
    """make_prefill_step (a 2-row batch written at 0) and three
    make_decode_step tokens at rising positions: last logits, next tokens
    and every cache slot within 1e-5·max of JAX's."""
    cfg, params, jcfg, jparams = model
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (2, 7))
    jcache = JM.init_cache(jcfg, 2, 16)
    jlast, jcache = jax.jit(jstep.make_prefill_step(jcfg))(
        jparams, jcache, {"tokens": jnp.asarray(prompt, jnp.int32)})
    cache = TM.init_cache(cfg, 2, 16, device="cpu")
    last, cache = tstep.make_prefill_step(cfg)(params, cache, {"tokens": torch.from_numpy(prompt)})
    _close(last, jlast, "prefill logits")
    jdecode = jax.jit(jstep.make_decode_step(jcfg))
    decode = tstep.make_decode_step(cfg)
    decode_l = tstep.make_decode_step(cfg, with_logits=True)
    tok = np.array(jnp.argmax(jlast, axis=-1))[:, None]
    for pos in (7, 8, 9):
        jnext, jcache = jdecode(jparams, jcache, jnp.asarray(tok, jnp.int32), jnp.int32(pos))
        probe = bridge.cache_from_numpy(bridge.cache_to_numpy(cache), "cpu")
        nxt, cache = decode(params, cache, torch.from_numpy(tok), pos)
        nxt_l, logits, _ = decode_l(params, probe, torch.from_numpy(tok), pos)
        assert np.array_equal(nxt.numpy(), np.asarray(jnext)), pos
        assert torch.equal(nxt_l, nxt) and torch.equal(logits.argmax(-1).to(nxt.dtype), nxt)
        tok = np.array(jnext)[:, None]
    got = bridge.cache_to_numpy(cache)
    for k in ("k", "v"):
        _close(got[k], np.asarray(jcache[k]), f"cache {k}")


def test_paged_steps_match_jax(model):
    """make_paged_prefill_step (chunk 3 over blocks of 4, a per-lane pos0
    vector, an inactive lane on scratch) and make_paged_decode_step against
    JAX's on the same pool, tables and tokens: every real position's logits
    and every written block (1 … NB−1; scratch block 0 takes the colliding
    writes of padded and inactive positions, in an order neither side fixes)
    within 1e-5·max."""
    cfg, params, jcfg, jparams = model
    scfg = ServeConfig(block_size=4, num_blocks=16, slots=3, max_len_cap=32, prefill_chunk=3)
    nb, C = scfg.blocks_per_table, scfg.prefill_chunk
    rng = np.random.default_rng(4)
    prompts = {0: rng.integers(0, cfg.vocab_size, 7), 1: rng.integers(0, cfg.vocab_size, 11)}
    alloc = BlockAllocator(scfg.num_blocks, scfg.block_size, nb)
    jkv_ = JM.init_paged_cache(jcfg, scfg.num_blocks, scfg.block_size)
    kv = TM.init_paged_cache(cfg, scfg.num_blocks, scfg.block_size, device="cpu")
    jprefill = jax.jit(jstep.make_paged_prefill_step(jcfg))
    jdecode = jax.jit(jstep.make_paged_decode_step(jcfg))
    prefill, decode = tstep.make_paged_prefill_step(cfg), tstep.make_paged_decode_step(cfg)
    done = {0: 0, 1: 0}
    last = {}
    # lane 1 starts one turn late, so pos0 differs across lanes; lane 2 is idle
    for turn in range(5):
        chunk = np.zeros((3, C), np.int32)
        bt = np.zeros((3, nb), np.int32)
        pos0 = np.zeros((3,), np.int32)
        real = {}
        for lane, prompt in prompts.items():
            if (lane == 1 and turn == 0) or done[lane] == len(prompt):
                continue
            c = min(C, len(prompt) - done[lane])
            alloc.ensure(lane, c)
            chunk[lane, :c] = prompt[done[lane]: done[lane] + c]
            bt[lane] = alloc.table_row(lane)
            pos0[lane] = done[lane]
            real[lane] = c
        jlogits, jkv_ = jprefill(jparams, jkv_, jnp.asarray(bt), jnp.asarray(pos0),
                                 jnp.asarray(chunk))
        logits, kv = prefill(params, kv, torch.from_numpy(bt), torch.from_numpy(pos0),
                             torch.from_numpy(chunk.astype(np.int64)))
        assert len(set(pos0[list(real)])) > 1 or turn == 0 or len(real) < 2
        for lane, c in real.items():
            _close(logits[lane, :c], np.asarray(jlogits)[lane, :c], f"prefill {turn} {lane}")
            alloc.advance(lane, c)
            done[lane] += c
            last[lane] = int(np.argmax(np.asarray(jlogits)[lane, c - 1]))
    assert done == {0: 7, 1: 11}
    for step in range(3):
        bt = np.zeros((3, nb), np.int32)
        pos = np.zeros((3,), np.int32)
        toks = np.zeros((3, 1), np.int32)
        for lane in prompts:
            alloc.ensure(lane, 1)
            bt[lane] = alloc.table_row(lane)
            pos[lane] = alloc.length(lane)
            toks[lane, 0] = last[lane]
        jlogits, jkv_ = jdecode(jparams, jkv_, jnp.asarray(bt), jnp.asarray(pos),
                                jnp.asarray(toks))
        logits, kv = decode(params, kv, torch.from_numpy(bt), torch.from_numpy(pos),
                            torch.from_numpy(toks.astype(np.int64)))
        for lane in prompts:
            _close(logits[lane], np.asarray(jlogits)[lane], f"decode {step} {lane}")
            alloc.advance(lane, 1)
            last[lane] = int(np.argmax(np.asarray(jlogits)[lane]))
    got = bridge.cache_to_numpy(kv)
    for k in ("kp", "vp"):
        _close(got[k][:, 1:], np.asarray(jkv_[k])[:, 1:], f"pool {k}")


# ---------------------------------------------------------------------------
# the Engine against JAX's
# ---------------------------------------------------------------------------


PROMPTS = [(3, 1, 4, 1, 5), (2, 7, 1), tuple(range(9))]


@pytest.mark.parametrize("chunk", [2, 32])
def test_engine_greedy_matches_jax_and_full_forward(model, jax_engine, chunk):
    """Chunked and single-chunk prefill: the port's Engine gives JAX's
    Engine's tokens and the full-forward greedy rollout's."""
    cfg, params, _, _ = model
    scfg = ServeConfig(block_size=4, num_blocks=32, slots=2, max_len_cap=32,
                       prefill_chunk=chunk)
    reqs = [Request(tokens=p, max_new=4) for p in PROMPTS]
    got, eng = _port_run(cfg, params, scfg, reqs)
    want, _ = _jax_run(jax_engine(scfg), reqs)
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [list(c.tokens) for c in got] == [_rollout(cfg, params, p, 4) for p in PROMPTS]
    assert all(c.finish_reason == "max_new" for c in got)
    assert eng.stats["generated_tokens"] == 12 and eng.stats["preemptions"] == 0


def test_engine_preemption_matches_jax(model, jax_engine):
    """tests/test_serve.py's eviction scenario: two requests that cannot
    coexist in a 7-block pool; the younger is preempted mid-decode, both
    finish with the uncontended run's tokens, as many preemptions as JAX's
    engine, and every block comes back."""
    cfg, params, _, _ = model
    prompt = tuple(int(t) for t in np.arange(7) % cfg.vocab_size)
    roomy = ServeConfig(block_size=4, num_blocks=32, slots=2, max_len_cap=32, prefill_chunk=4)
    (ref,), _ = _port_run(cfg, params, roomy, [Request(tokens=prompt, max_new=6)])
    tight = ServeConfig(block_size=2, num_blocks=8, slots=2, max_len_cap=24, prefill_chunk=4)
    reqs = [Request(tokens=prompt, max_new=6), Request(tokens=prompt, max_new=6)]
    got, eng = _port_run(cfg, params, tight, reqs)
    want, jpre = _jax_run(jax_engine(tight), reqs)
    assert eng.stats["preemptions"] >= 1 and eng.stats["preemptions"] == jpre
    assert [c.finish_reason for c in got] == ["max_new", "max_new"]
    assert [c.tokens for c in got] == [c.tokens for c in want] == [ref.tokens] * 2
    assert [c.preemptions for c in got] == [c.preemptions for c in want]
    assert got[1].preemptions >= 1  # the younger request bore the eviction


def test_engine_sampling_matches_jax(model, jax_engine):
    """Seeded sampling (the reference's per-request test): the port draws
    JAX's tokens from the same seeds, a seed repeats its stream, seeds
    differ, and greedy ignores the seed."""
    cfg, params, _, _ = model
    scfg = ServeConfig(block_size=4, num_blocks=32, slots=2, max_len_cap=32, prefill_chunk=8)
    prompt = (3, 1, 4, 1, 5)
    reqs = [Request(tokens=prompt, max_new=8, temperature=t, top_k=k, seed=s)
            for t, k, s in ((0.0, 0, 0), (5.0, 0, 42), (5.0, 0, 42), (5.0, 0, 43),
                            (0.8, 50, 1), (0.0, 0, 99))]
    got, _ = _port_run(cfg, params, scfg, reqs)
    want, _ = _jax_run(jax_engine(scfg), reqs)
    toks = [c.tokens for c in got]
    assert toks == [c.tokens for c in want]
    assert toks[1] == toks[2] and toks[1] != toks[3] and toks[0] == toks[5]


def test_engine_api_and_limits(model):
    """submit / poll / result / has_work, per-request max_len ("length"), an
    infeasible request ("error"), generate_batch, and the background thread
    (start / stop) giving the inline run's tokens."""
    cfg, params, _, _ = model
    scfg = ServeConfig(block_size=4, num_blocks=32, slots=2, max_len_cap=16, prefill_chunk=8)
    eng = Engine(cfg, params, scfg)
    assert eng.poll() == [] and not eng.has_work()
    r1 = eng.submit(Request(tokens=(3, 1, 4), max_new=2))
    r2 = eng.submit(Request(tokens=(2, 7, 1, 8, 2), max_len=7, max_new=50))
    assert eng.has_work()
    done = eng.run_until_drained()
    assert {c.request_id for c in done} == {r1, r2} and eng.poll() == []
    c1, c2 = eng.result(r1), eng.result(r2)
    assert c1.finish_reason == "max_new" and len(c1.tokens) == 2
    assert c2.finish_reason == "length" and len(c2.tokens) == 2
    assert c2.ttft_s >= 0 and c2.latency_s >= c2.ttft_s
    r3 = eng.submit(Request(tokens=tuple(range(20)), max_new=4))
    eng.run_until_drained()
    assert eng.result(r3).finish_reason == "error"
    assert eng.pool_hbm_bytes == sum(t.nbytes for t in eng.kv.values())
    outs = generate_batch(eng, PROMPTS, max_new=3)
    assert outs == [_rollout(cfg, params, p, 3) for p in PROMPTS]
    eng.start()
    try:
        ids = [eng.submit(Request(tokens=p, max_new=3)) for p in PROMPTS]
        eng.run_until_drained(timeout_s=60)
    finally:
        eng.stop()
    assert [list(eng.result(i).tokens) for i in ids] == outs


def test_padded_chunk_past_the_table_goes_to_scratch(model, jax_engine):
    """ROADMAP C.11: max_len_cap 100 (7 blocks of 16 = 112 slots), chunk 32,
    a 99-token prompt: the last chunk (96 … 127) pads past the table. The
    reference clamps positions 112 … 127 onto block 6, over the K/V of real
    tokens 96 … 98 of the same chunk, and its engine's token leaves the full
    forward's; the port sends them to scratch, and its last-chunk logits and
    token are the full forward's."""
    cfg, params, _, _ = model
    scfg = ServeConfig(block_size=16, num_blocks=16, slots=2, max_len_cap=100, prefill_chunk=32)
    prompt = tuple(int(t) for t in np.random.default_rng(0).integers(0, cfg.vocab_size, 99))
    with torch.no_grad():
        full = TM.forward(cfg, params, {"tokens": torch.tensor([prompt])})[0]
    want = int(full[-1].argmax())
    (got,), eng = _port_run(cfg, params, scfg, [Request(tokens=prompt, max_new=1)])
    assert got.tokens == (want,)
    (jgot,), _ = _jax_run(jax_engine(scfg), [Request(tokens=prompt, max_new=1)])
    assert jgot.tokens != (want,)  # the reference's fault, not copied
    # the last chunk's logits, position by position, through the paged steps
    _, _, jcfg, jparams = model
    kv = TM.init_paged_cache(cfg, scfg.num_blocks, scfg.block_size, device="cpu")
    jkv_ = JM.init_paged_cache(jcfg, scfg.num_blocks, scfg.block_size)
    alloc = BlockAllocator(scfg.num_blocks, scfg.block_size, scfg.blocks_per_table)
    prefill = tstep.make_paged_prefill_step(cfg)
    jprefill = jax.jit(jstep.make_paged_prefill_step(jcfg))
    for p0 in range(0, 99, 32):
        c = min(32, 99 - p0)
        alloc.ensure(1, c)
        chunk = np.zeros((1, 32), np.int64)
        chunk[0, :c] = prompt[p0:p0 + c]
        bt = alloc.table_row(1)[None]
        logits, kv = prefill(params, kv, torch.from_numpy(bt), p0, torch.from_numpy(chunk))
        jlogits, jkv_ = jprefill(jparams, jkv_, jnp.asarray(bt), p0, jnp.asarray(chunk, jnp.int32))
        alloc.advance(1, c)
    _close(logits[0, :3], full[96:], "last chunk")
    gap = float(np.abs(np.asarray(jlogits)[0, :3] - full[96:].numpy()).max())
    assert gap > 1e-2 * float(full[96:].abs().max())  # the reference's clobbered K/V


# ---------------------------------------------------------------------------
# checkpoints, the CLI and the Server shim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_load_checkpoint_params_matches_jax(model, tmp_path, quantize):
    """A checkpoint written by repro.checkpoint.manager (params, plain or the
    int8 file codec, plus an optimizer group the loader leaves on disk):
    load_checkpoint_params gives JAX's load_checkpoint_params's params bit
    for bit, and the engine serves them."""
    from repro.checkpoint.manager import CheckpointManager as JCheckpointManager

    cfg, _, jcfg, jparams = model
    mgr = JCheckpointManager(str(tmp_path), async_save=False, quantize=quantize)
    mgr.save(3, {"params": jparams, "opt": {"m": jnp.ones((4,))}}, block=True)
    jp, jstep_ = jlaunch.load_checkpoint_params(jcfg, str(tmp_path))
    params, step = tlaunch.load_checkpoint_params(cfg, str(tmp_path), device="cpu")
    assert step == jstep_ == 3
    want = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    got = bridge.params_to_numpy(params)
    flat = {".".join(str(k.key) for k in path): v for path, v in want.items()}
    from repro_torch.utils import tree_leaves_with_path
    assert sorted(flat) == [p for p, _ in tree_leaves_with_path(got)]
    for path, leaf in tree_leaves_with_path(got):
        assert np.array_equal(leaf, np.asarray(flat[path], np.float32)), path
    assert all(t.requires_grad for _, t in tree_leaves_with_path(params))
    with pytest.raises(FileNotFoundError):
        tlaunch.load_checkpoint_params(cfg, str(tmp_path / "none"), device="cpu")


def test_cli_in_process(tmp_path, capsys):
    """`--device cpu` serves the demo requests on the default architecture,
    the reference's qwen2_7b; without it (and no GPU) the CLI exits 2 with "no
    CUDA device"; `--ckpt-dir` serves a checkpoint of the named --arch."""
    if torch.cuda.is_available():
        pytest.skip("the no-GPU refusal needs a machine without a CUDA device")
    assert tlaunch.build_parser().parse_args([]).arch == "qwen2_7b"
    assert jlaunch.build_parser().parse_args([]).arch == "qwen2_7b"
    tlaunch.main(["--device", "cpu", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] engine up on cpu" in out and out.count("[max_new") == 2
    with pytest.raises(SystemExit) as e:
        tlaunch.main([])
    assert e.value.code == 2 and "no CUDA device" in capsys.readouterr().err
    from repro_torch.checkpoint import CheckpointManager

    cfg = get_config("llama_60m", smoke=True)
    CheckpointManager(str(tmp_path), async_save=False).save(
        5, {"params": TM.init_params(cfg, seed=3, device="cpu")}, block=True)
    tlaunch.main(["--arch", "llama_60m", "--device", "cpu", "--max-new", "2", "--ckpt-dir",
                  str(tmp_path)])
    assert f"restored params from {tmp_path} step 5" in capsys.readouterr().out


def test_server_shim_deprecated_and_equivalent(model):
    """The deprecated Server warns, pins no contiguous cache, and gives the
    engine's (and the full forward's) greedy tokens."""
    cfg, params, _, _ = model
    with pytest.warns(DeprecationWarning):
        srv = tlaunch.Server(cfg, params, max_len=32, slots=2)
    prompt = np.asarray([3, 1, 4, 1, 5])
    outs = srv.generate([prompt, prompt[:3]], max_new=3)
    assert outs == [_rollout(cfg, params, p, 3) for p in (prompt, prompt[:3])]
    assert not hasattr(srv, "cache")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        s2 = tlaunch.Server(cfg, params, max_len=32, slots=2)
    assert s2.engine.scfg.num_blocks == 1 + 2 * 2


def test_steps_refuse_without_a_device_and_run_inference_only(model):
    """Entry points without a device raise where there is no GPU (no CPU
    fallback); the steps keep no autograd graph of the weights."""
    cfg, params, _, _ = model
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_paged_cache(cfg, 4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.load_checkpoint_params(cfg, "/nonexistent")
    kv = TM.init_paged_cache(cfg, 4, 4, device="cpu")
    logits, _ = tstep.make_paged_decode_step(cfg)(
        params, kv, torch.zeros((1, 2), dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
        torch.zeros((1, 1), dtype=torch.int64))
    assert not logits.requires_grad and logits.grad_fn is None
