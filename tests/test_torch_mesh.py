"""The pod's sharding rules and mesh in the port (launch/mesh.py,
utils.ShardingRules, distributed/state_sharding.py::optimizer_state_axes,
the steps' `rules`), held against the JAX package.

The rules' specs and the optimizer state's axes tree are compared leaf for
leaf; each rank's bytes of the sharded specs against JAX's ``shard_shape``
sums (JAX in a subprocess with 512 forced host devices, the port as rank 0
of a fake world); and the reference's multi-device setting trains on a
2 × 2 gloo world of CPU processes, held to the port's unsharded step and
to JAX's unsharded run.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_threads import one_thread  # noqa: E402,F401
from torch_world import mesh_cases, mesh_run, run_world  # noqa: E402

from repro.configs.base import GaLoreConfig as JGaLoreConfig  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.distributed import state_sharding as jstate_sharding  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.quant import QuantPolicy as JQuantPolicy  # noqa: E402
from repro.utils import is_axes as jis_axes  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, GaLoreConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.distributed import step as tstep  # noqa: E402
from repro_torch.distributed.state_sharding import map_axes, optimizer_state_axes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.factory import build_optimizer  # noqa: E402
from repro_torch.quant import QuantPolicy  # noqa: E402
from repro_torch.utils import (  # noqa: E402
    axes_by_path,
    is_axes,
    is_dtensor,
    logical_constraint,
    sharding_context,
    tree_leaves,
    tree_leaves_with_path,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16),
                                                             ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# the rules: spec_for and placements_for against the reference
# ---------------------------------------------------------------------------


def _jax_paths(tree):
    """{(path keys…): axes} of a JAX axes tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=jis_axes)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path): ax
            for path, ax in flat}


def _shapes_by_path(tree):
    return {path: tuple(x.shape) for path, x in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("variant", tmesh.VARIANTS)
def test_spec_for_matches_the_reference_on_every_leaf(mesh_name, variant):
    """Every param_axes leaf of all ten archs (and the attention families'
    cache leaves), with and without long_context: the same mesh axes, dim
    for dim, as the reference's ShardingRules.spec_for on an AbstractMesh;
    placements_for shards a tensor dim on exactly the mesh dims of its spec."""
    from torch.distributed.tensor import Replicate, Shard

    sizes, names = MESHES[mesh_name]
    jabstract = jax.sharding.AbstractMesh(sizes, names)
    named = tmesh.NamedShape(sizes, names)
    checked = 0
    for long_context in (False, True):
        jr = jmesh.rules_variant(jabstract, variant, long_context=long_context)
        tr = tmesh.rules_variant(named, variant, long_context=long_context)
        assert dict(tr.rules) == {k: (tuple(v) if isinstance(v, list) else v)
                                  for k, v in jr.rules.items()}
        for arch in ARCH_IDS:
            cfg = get_config(arch)
            trees = [(M.param_axes(cfg), M.init_params(cfg, device="meta"))]
            if cfg.family in ("dense", "moe", "vlm"):
                trees.append((M.cache_axes(cfg), M.init_cache(cfg, 8, 4096, device="meta")))
            for axes, struct in trees:
                shapes = _shapes_by_path(struct)
                for path, ax in axes_by_path(axes).items():
                    shape = shapes[path]
                    want = tuple(jr.spec_for(ax, shape))
                    want = want + (None,) * (len(ax) - len(want))
                    got = tr.spec_for(ax, shape)
                    assert got == want, (arch, path, variant, long_context)
                    placements = tr.placements_for(ax, shape)
                    for i, name in enumerate(names):
                        dims = [d for d, a in enumerate(got)
                                if a == name or (isinstance(a, tuple) and name in a)]
                        assert placements[i] == (Shard(dims[0]) if dims and sizes[i] > 1
                                                 else Replicate())
                    checked += 1
    assert checked > 600


def test_reference_param_axes_are_the_ports():
    """The port's param_axes is the reference's, path for path, on every arch
    (what the specs above are taken over)."""
    for arch in ARCH_IDS:
        want = _jax_paths(JM.param_axes(jget_config(arch)))
        got = {tuple(p.split(".")): ax
               for p, ax in axes_by_path(M.param_axes(get_config(arch))).items()}
        assert {tuple(str(k) for k in p): a for p, a in want.items()} == got, arch


def test_logical_constraint_is_a_noop_without_a_context():
    x = torch.randn(4, 8)
    assert logical_constraint(x, "batch", "act_seq") is x
    rules = tmesh.default_rules(tmesh.NamedShape((2, 2), ("data", "model")))
    with sharding_context(rules):  # a plain tensor: nothing to place
        assert logical_constraint(x, "batch", "act_seq") is x


# ---------------------------------------------------------------------------
# optimizer_state_axes: the reference's tree, and the port's state's
# ---------------------------------------------------------------------------


def _port_axes_paths(tree):
    out = {}

    def walk(a, prefix):
        if is_axes(a):
            out[prefix] = a
        elif isinstance(a, dict):
            for k in sorted(a):
                walk(a[k], prefix + (k,))
        else:
            for i, x in enumerate(a):
                walk(x, prefix + (i,))

    walk(tree, ())
    return out


QUANT = {"fp32": ("fp32", "fp32"), "int8": ("int8", "fp32"), "int4p": ("fp32", "int4"),
         "int8_int4p": ("int8", "int4")}


@pytest.mark.parametrize("optimizer,quant", [
    (o, q) for o in ("adamw", "adam8bit", "adafactor") for q in QUANT
    if not (o == "adafactor" and QUANT[q][0] == "int8")])  # both packages refuse that
def test_optimizer_state_axes_match_the_reference_leaf_for_leaf(optimizer, quant):
    """The axes tree of every optimizer (fp32, int8 moments, int4 P) on the
    archs of the reference's structure test: path for path the reference's,
    and it zips with the port's own state tree, every tensor leaf labelled."""
    moments, proj = QUANT[quant]
    for arch in ["qwen2_7b", "grok_1_314b", "jamba_1_5_large_398b", "whisper_small",
                 "mamba2_130m", "llama_60m"]:
        jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
        jtc = JTrainConfig(optimizer=optimizer, galore_external_refresh=True,
                           galore=JGaLoreConfig(rank=8, quant=JQuantPolicy(moments=moments,
                                                                           projectors=proj)))
        tc = TrainConfig(optimizer=optimizer, galore_external_refresh=True,
                         galore=GaLoreConfig(rank=8, quant=QuantPolicy(moments=moments,
                                                                       projectors=proj)))
        pstruct = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.PRNGKey(0)))
        want = _jax_paths(jstate_sharding.optimizer_state_axes(jtc, JM.param_axes(jcfg), pstruct))
        params = M.init_params(cfg, device="meta")
        axes = optimizer_state_axes(tc, M.param_axes(cfg), params)
        got = _port_axes_paths(axes)
        assert got == want, (arch, optimizer, quant)
        state = build_optimizer(tc, param_axes=M.param_axes(cfg)).init(params)
        seen = []
        map_axes(lambda ax, x: seen.append(x) if isinstance(x, torch.Tensor) else None,
                 axes, state)
        tensors = [x for x in tree_leaves(state) if isinstance(x, torch.Tensor)]
        assert len(seen) == len(tensors), (arch, optimizer, quant)


# ---------------------------------------------------------------------------
# each rank's bytes of the sharded specs
# ---------------------------------------------------------------------------

CELLS = [("llama_7b", "train_4k"), ("grok_1_314b", "train_4k"), ("qwen2_7b", "prefill_32k")]
JAX_BYTES = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json, math, sys
    import jax, numpy as np
    from repro.configs.base import get_config
    from repro.distributed.step import input_specs
    from repro.launch.dryrun import default_train_config
    from repro.launch.mesh import make_production_mesh, rules_variant
    out = {}
    for multi in (False, True):
        rules = rules_variant(make_production_mesh(multi_pod=multi), "baseline")
        for arch, shape in json.loads(sys.argv[1]):
            cfg = get_config(arch)
            specs = input_specs(cfg, shape, default_train_config(cfg), rules)
            out[f"{arch}|{shape}|{multi}"] = {
                k: sum(math.prod(x.sharding.shard_shape(x.shape)) * np.dtype(x.dtype).itemsize
                       for x in jax.tree_util.tree_leaves(v))
                for k, v in specs.items() if k in ("params", "opt_state", "cache")}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_bytes():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_BYTES, json.dumps(CELLS)], check=True,
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def rank_bytes(tree) -> int:
    """A rank's bytes of a tree of (D)Tensors; the galore state's step, a
    host int in the port, counts as the reference's int32 scalar."""
    total = 0
    for path, x in tree_leaves_with_path(tree):
        if isinstance(x, torch.Tensor):
            local = x.to_local() if is_dtensor(x) else x
            total += local.numel() * local.element_size()
        elif path.endswith("step") and isinstance(x, int):
            total += 4
    return total


def test_sharded_specs_hold_the_reference_bytes_per_rank(jax_bytes):
    """input_specs with rules (rank 0 of a fake 256- and 512-rank world): the
    params, optimizer state and cache bytes of a rank are exactly JAX's
    shard_shape sums, the figures of the reference's dry run included."""
    got = {}
    for multi in (False, True):
        with dryrun.fake_world(512 if multi else 256):
            rules = tmesh.rules_variant(tmesh.make_production_mesh(multi_pod=multi,
                                                                   device_type="cpu"),
                                        "baseline")
            for arch, shape in CELLS:
                cfg = get_config(arch)
                specs = tstep.input_specs(cfg, shape, dryrun.default_train_config(cfg), rules)
                got[f"{arch}|{shape}|{multi}"] = {k: rank_bytes(v) for k, v in specs.items()
                                                   if k in ("params", "opt_state", "cache")}
        assert not torch.distributed.is_initialized()
    assert got == jax_bytes
    for multi in (False, True):
        assert got[f"llama_7b|train_4k|{multi}"] == {"params": 67_011_072,
                                                     "opt_state": 351_143_972}
        assert got[f"grok_1_314b|train_4k|{multi}"] == {"params": 2_561_508_096,
                                                        "opt_state": 6_809_324_592}
    assert got["qwen2_7b|prefill_32k|False"]["cache"] == 234_881_024
    assert got["qwen2_7b|prefill_32k|True"]["cache"] == 117_440_512


# ---------------------------------------------------------------------------
# training on a 2 × 2 mesh of CPU processes
# ---------------------------------------------------------------------------


def _spec(params, **kw):
    toks = np.tile(np.arange(32, dtype=np.int64)[None], (8, 1)) % 512
    spec = dict(params=params, tokens=toks, steps=6, every=3,
                tc=dict(optimizer="adamw", lr=1e-2, total_steps=6, warmup_steps=1,
                        galore_external_refresh=True),
                galore=dict(rank=8, update_freq=3, projector="newton_schulz"))
    spec.update(kw)
    return spec


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """JAX's unsharded run of the reference's multi-device setting; the
    port's unsharded refresh and first step; one world of 4 processes on a
    2 × 2 mesh running the same first step from that refreshed state, and
    the 6-step trajectory with its own sharded refreshes."""
    from repro.distributed.step import make_refresh_step, make_train_step
    from repro_torch.bridge import galore_state_to_numpy, params_from_numpy, params_to_numpy
    from repro_torch.optim.factory import galore_state_index

    jcfg = jget_config("llama_60m", smoke=True)
    jtc = JTrainConfig(optimizer="adamw", lr=1e-2, total_steps=6, warmup_steps=1,
                       galore=JGaLoreConfig(rank=8, update_freq=3, projector="newton_schulz"),
                       galore_external_refresh=True)
    jstep, jopt = make_train_step(jcfg, jtc)
    jrefresh = jax.jit(make_refresh_step(jcfg, jtc))
    jstep = jax.jit(jstep)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    p0 = jax.tree_util.tree_map(np.asarray, params)
    state = jopt.init(params)
    batch = {"tokens": jax.numpy.asarray(_spec(p0)["tokens"], jax.numpy.int32)}
    jlosses = []
    for i in range(6):
        if i % 3 == 0:
            state = jrefresh(params, state, batch)
        params, state, m = jstep(params, state, batch)
        jlosses.append(float(m["loss"]))
    # the port's unsharded refresh and step 0: the state both step 1s start from
    cfg = get_config("llama_60m", smoke=True)
    tc = TrainConfig(optimizer="adamw", lr=1e-2, total_steps=6, warmup_steps=1,
                     galore=GaLoreConfig(rank=8, update_freq=3, projector="newton_schulz"),
                     galore_external_refresh=True)
    step_fn, opt = tstep.make_train_step(cfg, tc)
    tparams = params_from_numpy(p0, "cpu")
    tbatch = {"tokens": torch.from_numpy(_spec(p0)["tokens"])}
    state = tstep.make_refresh_step(cfg, tc)(tparams, opt.init(tparams), tbatch)
    tparams, state, _ = step_fn(tparams, state, tbatch)
    p1 = params_to_numpy(tparams)
    at1 = dict(galore0=galore_state_to_numpy(state[galore_state_index(tc)]),
               count0=int(state[-1]["count"]), steps=1)
    one = mesh_run(_spec(p1, **at1))
    cases = {"step": _spec(p1, mesh=(2, 2), **at1), "traj": _spec(p0, mesh=(2, 2))}
    world = run_world(mesh_cases, 4, tmp_path_factory.mktemp("mesh"), cases)
    return {"p1": p1, "jlosses": jlosses, "one": one, "world": world}


def test_mesh_step_matches_the_unsharded_step(mesh_world):
    """Step 1 on the 2 × 2 mesh from the unsharded run's state after its
    refresh and step 0: each leaf's update within 2e-5 of the port's
    unsharded step 1 in Frobenius norm (ROADMAP note 24), on every rank."""
    before = jax.tree_util.tree_leaves(mesh_world["p1"])
    want = jax.tree_util.tree_leaves(mesh_world["one"]["first"])
    for rank in mesh_world["world"]:
        got = jax.tree_util.tree_leaves(rank["step"]["first"])
        for (path, _), b, w, g in zip(tree_leaves_with_path(mesh_world["one"]["first"]),
                                      before, want, got):
            dw = np.asarray(w, np.float64) - b
            dg = np.asarray(g, np.float64) - b
            assert np.linalg.norm(dg - dw) <= 2e-5 * np.linalg.norm(dw), path


def test_mesh_trajectory_matches_jax_and_shards_the_weights(mesh_world):
    """The reference's 6 steps (sharded refreshes at 0 and 3) on the 2 × 2
    mesh: every loss within 5e-2 of the JAX package's unsharded run, the loss
    falls, and blocks.ffn.gate is sharded on both mesh dims."""
    for rank in mesh_world["world"]:
        losses = rank["traj"]["losses"]
        np.testing.assert_allclose(losses, mesh_world["jlosses"], atol=5e-2)
        assert losses[-1] < losses[0]
        assert rank["traj"]["gate"] == ["S(1)", "S(2)"]


# ---------------------------------------------------------------------------
# a mesh of one rank, and what does not run on a larger mesh yet
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield tmesh.default_rules(tmesh.make_sim_mesh(1, 1, device_type="cpu"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fused", [False, True])
def test_mesh_of_one_is_the_unsharded_step_bit_for_bit(world_of_one, fused):
    """Three refresh-and-step rounds on a 1 × 1 mesh: losses and every param
    bit for bit the unsharded run's (fused: the kernels' dispatchers on the
    local tensors, their plain versions on the CPU)."""
    from repro_torch.bridge import params_from_numpy

    cfg = get_config("llama_60m", smoke=True)
    tc = TrainConfig(optimizer="adamw", lr=1e-2, total_steps=6, warmup_steps=1,
                     galore=GaLoreConfig(rank=8, update_freq=3), galore_fused_adam=fused,
                     galore_external_refresh=True)
    rng = np.random.default_rng(0)
    p0 = {path: rng.standard_normal(x.shape).astype(np.float32) * 0.05
          for path, x in tree_leaves_with_path(M.init_params(cfg, device="meta"))}
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)))
    runs = []
    for rules in (None, world_of_one):
        params = M.init_params(cfg, device="cpu")
        with torch.no_grad():
            for path, x in tree_leaves_with_path(params):
                x.copy_(torch.from_numpy(p0[path]))
        step, opt = tstep.make_train_step(cfg, tc, rules)
        refresh = tstep.make_refresh_step(cfg, tc, rules)
        state = opt.init(params)
        if rules is not None:
            state = tstep.shard_opt_state(cfg, tc, state, params, rules)
            params = tstep.shard_params(cfg, params, rules)
        losses = []
        for i in range(3):
            state = refresh(params, state, {"tokens": tokens}, i)
            params, state, m = step(params, state, {"tokens": tokens})
            losses.append(m["loss"])
        runs.append((losses, [x.full_tensor() if is_dtensor(x) else x
                              for x in tree_leaves(params)]))
    (l0, p0_), (l1, p1_) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0_, p1_))


def test_non_dense_families_and_fused_kernels_raise_on_a_2x2_mesh():
    """Over a 2 × 2 mesh an MoE (and every other non-dense) model's step
    raises naming the ROADMAP item, and so do the fused kernels, naming the
    leaf; the galore-DP, guarded and ZeRO steps raise too."""
    with dryrun.fake_world(4):
        rules = tmesh.default_rules(tmesh.make_sim_mesh(2, 2, device_type="cpu"))
        tc = TrainConfig(optimizer="adamw", galore=GaLoreConfig(rank=8),
                         galore_external_refresh=True)
        for arch in ["grok_1_314b", "qwen2_vl_7b", "mamba2_130m", "jamba_1_5_large_398b",
                     "whisper_small"]:
            with pytest.raises(NotImplementedError, match="ROADMAP A.13"):
                tstep.make_train_step(get_config(arch, smoke=True), tc, rules)
        cfg = get_config("llama_60m", smoke=True)
        for flag in ("galore_dp_compress", "anomaly_guard"):
            with pytest.raises(NotImplementedError, match="ROADMAP A.13"):
                tstep.make_train_step(cfg, dataclasses.replace(tc, **{flag: True}), rules)
        fused = TrainConfig(optimizer="adamw", galore=GaLoreConfig(rank=8),
                            galore_fused_adam=True, galore_external_refresh=True)
        step, opt = tstep.make_train_step(cfg, fused, rules)
        params = M.init_params(cfg, device="cpu")
        state = tstep.shard_opt_state(cfg, fused, opt.init(params), params, rules)
        params = tstep.shard_params(cfg, params, rules)
        tokens = torch.zeros((4, 32), dtype=torch.int64)
        with pytest.raises(NotImplementedError, match=r"blocks\.attn\.wk.*ROADMAP A\.13"):
            step(params, state, {"tokens": tokens})
    assert not torch.distributed.is_initialized()


def test_mesh_module_imports_no_device_state():
    """Building rules needs no world: a NamedShape is enough, and the
    data-parallel axes are the reference's."""
    single = tmesh.default_rules(tmesh.production_shape(False))
    multi = tmesh.default_rules(tmesh.production_shape(True))
    assert tmesh.data_parallel_axes(single) == ("data",)
    assert tmesh.data_parallel_axes(multi) == ("pod", "data")
    assert (tmesh.data_parallel_size(single), tmesh.data_parallel_size(multi)) == (16, 32)
    assert math.prod(multi.mesh_shape.values()) == 512
    with pytest.raises(ValueError):
        tmesh.rules_variant(tmesh.production_shape(False), "fsdp")
