"""The port's dry run (launch/dryrun.py, launch/hillclimb.py,
launch/model_flops.py, distributed/step.py::input_specs) against the JAX
package and against itself on the CPU: param_counts and model_flops equal
to the reference's for all ten architectures, the meta init's leaves equal
to the CPU init's, the live-bytes tracker's peak on a real CPU step equal to
its peak on the meta step, two microbatches peaking as N do, every kernel
wrapper's shape-only launch (the CUDA branch's outputs, no launch counted),
run_cell's records, the CLI's resume and --force, and hillclimb's
overrides."""
import dataclasses
import json
import math
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs.base import SHAPES as J_SHAPES  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import model_flops as jmf  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ARCH_IDS,
    SHAPES,
    GaLoreConfig,
    TrainConfig,
    get_config,
)
from repro_torch.distributed.step import batch_specs, input_specs, make_train_step  # noqa: E402
from repro_torch.kernels import adam8bit_update as a8  # noqa: E402
from repro_torch.kernels import galore_fused as tk  # noqa: E402
from repro_torch.kernels import galore_project as tp  # noqa: E402
from repro_torch.kernels import meta  # noqa: E402
from repro_torch.kernels import rmsnorm as trms  # noqa: E402
from repro_torch.launch import dryrun, hillclimb  # noqa: E402
from repro_torch.launch import model_flops as tmf  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.quant import QuantPolicy, codec  # noqa: E402
from repro_torch.utils import tree_leaves, tree_leaves_with_path  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401


# ---------------------------------------------------------------------------
# model_flops
# ---------------------------------------------------------------------------


def test_arch_ids_are_the_reference_s():
    assert list(ARCH_IDS) == list(J_ARCH_IDS) and list(SHAPES) == list(J_SHAPES)


@pytest.mark.parametrize("arch", list(J_ARCH_IDS))
def test_param_counts_and_model_flops_equal_the_reference(arch):
    """At full size: total exactly, active to 1e-12 relative (the expert
    leaves scaled by K/E), and model_flops of every shape likewise."""
    want = jmf.param_counts(jax_get_config(arch))
    got = tmf.param_counts(get_config(arch))
    assert got["total"] == want["total"]
    assert got["active"] == pytest.approx(want["active"], rel=1e-12)
    for shape in J_SHAPES:
        assert tmf.model_flops(get_config(arch), shape) == pytest.approx(
            jmf.model_flops(jax_get_config(arch), shape), rel=1e-12), shape


def test_moe_active_counts_experts_at_k_over_e():
    """grok-1's active count is below its total by the non-routed expert
    share: every expert leaf counts K/E of its elements."""
    cfg = get_config("grok_1_314b")
    c = tmf.param_counts(cfg)
    axes = dict(tmf._axes_by_path(M.param_axes(cfg)))
    experts = sum(math.prod(p.shape) for path, p in tree_leaves_with_path(
        M.init_params(cfg, device="meta")) if "experts" in (axes.get(path) or ()))
    assert experts > 0
    assert c["active"] == pytest.approx(
        c["total"] - experts * (1 - cfg.experts_per_token / cfg.n_experts), rel=1e-12)


# ---------------------------------------------------------------------------
# the meta init and input_specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ARCH_IDS) + ["llama_60m"])
def test_meta_init_gives_the_cpu_init_s_leaves(arch):
    cfg = get_config(arch, smoke=True)
    cpu = tree_leaves_with_path(M.init_params(cfg, device="cpu"))
    got = tree_leaves_with_path(M.init_params(cfg, device="meta"))
    assert [p for p, _ in got] == [p for p, _ in cpu]
    for (path, a), (_, b) in zip(got, cpu):
        assert a.is_meta and (a.shape, a.dtype, a.requires_grad) == (
            b.shape, b.dtype, b.requires_grad), path


@pytest.mark.parametrize("shape", list(SHAPES))
def test_input_specs_are_meta_with_the_cell_s_shapes(shape):
    cfg = get_config("qwen2_vl_7b", smoke=True)
    cell = SHAPES[shape]
    specs = input_specs(cfg, shape, TrainConfig(galore=GaLoreConfig(rank=8)))
    host = [p for p, t in tree_leaves_with_path(specs)
            if isinstance(t, torch.Tensor) and not t.is_meta]
    assert host == (["opt_state.1.key"] if cell.kind == "train" else [])  # the sketch key
    if cell.kind == "decode":
        assert tuple(specs["tokens"].shape) == (cell.global_batch, 1)
        assert set(specs) == {"params", "cache", "tokens", "pos"}
        return
    b = specs["batch"]
    assert tuple(b["tokens"].shape) == (cell.global_batch, cell.seq_len)
    assert tuple(b["positions"].shape) == (3, cell.global_batch, cell.seq_len)  # M-RoPE
    assert tuple(b["media"].shape) == (cell.global_batch, cfg.media_embeds, cfg.d_model)
    assert ("opt_state" in specs) == (cell.kind == "train")


# ---------------------------------------------------------------------------
# the live-bytes tracker and the microbatches
# ---------------------------------------------------------------------------


def _peaks(device, tc, steps=2, rows=4, seq=32):
    cfg = get_config("llama_60m", smoke=True)
    params = M.init_params(cfg, device=device)
    step, opt = make_train_step(cfg, tc)
    state = opt.init(params)
    batch = {"tokens": torch.zeros((rows, seq), dtype=torch.int64, device=device)}
    out = []
    for _ in range(steps):
        with dryrun.LiveBytes(dryrun._tensors(params, state, batch)) as live:
            params, state, _ = step(params, state, batch)
        out.append((live.base, live.peak, live.peak_op))
    return out


@pytest.mark.parametrize("tc", [
    TrainConfig(optimizer="adamw"),
    TrainConfig(optimizer="adamw", galore=GaLoreConfig(rank=8, update_freq=2)),
    TrainConfig(optimizer="adamw", galore=GaLoreConfig(
        rank=8, update_freq=2, quant=QuantPolicy(moments="int8", projectors="int4",
                                                 min_quant_size=0))),
], ids=["adamw", "galore_composable", "galore_8bit_composable"])
def test_tracker_peak_on_a_cpu_step_equals_the_meta_step(tc):
    """Kernel-free steps (AdamW, GaLore's composable path, fp32 and 8-bit):
    the tracker reads the same resident bytes, peak and peak op on a real
    CPU step as on the meta step, at a refresh step and after it."""
    got, want = _peaks("meta", tc), _peaks("cpu", tc)
    assert got == want
    assert all(peak > base for base, peak, _ in got)


def test_two_microbatches_peak_as_n_do():
    """make_train_step at 4 microbatches of 2 rows: the same peak (and the
    same peak op) as at 2 microbatches of 2 rows, and dry_run_step's FLOPs
    (2 run, 2 added) equal the 4-microbatch step's."""
    cfg = get_config("llama_60m", smoke=True)
    tc = TrainConfig(optimizer="adamw", microbatch=4)
    params = M.init_params(cfg, device="meta")
    step, opt = make_train_step(cfg, tc)
    state = opt.init(params)
    batch = batch_specs(cfg, dataclasses.replace(SHAPES["train_4k"], global_batch=8, seq_len=32))
    _, full = dryrun._measure(lambda: step(params, state, batch),
                              dryrun._tensors(params, state, batch))
    rec = dryrun.dry_run_step(cfg, tc, 8, 32, "train")
    assert rec["peak_bytes"] == full["peak"] and rec["peak_op"] == full["peak_op"]
    assert rec["flops"] == full["flops"]


def test_microbatches_split_mrope_positions_on_their_batch_dim():
    """ROADMAP C.29: Qwen2-VL's batch carries M-RoPE positions (3, B, S); at
    2 microbatches the port splits them on dim 1, the batch, and takes the
    one-shot step's loss (within 1e-6) and gradients (within 1e-5·max). The
    reference reshapes every leaf's dim 0 into (nm, B / nm) and raises on
    the same batch."""
    import jax.numpy as jnp
    import numpy as np

    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.distributed import step as jstep
    from repro_torch.distributed.step import _local_grads_and_loss

    cfg = get_config("qwen2_vl_7b", smoke=True)
    params = M.init_params(cfg, device="cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (4, 16))
    pos = np.broadcast_to(np.arange(16), (3, 4, 16)).copy()
    pos[1:, 1] += 5  # the rows' positions differ: a split on the wrong dim shows
    batch = {"tokens": torch.from_numpy(tokens), "positions": torch.from_numpy(pos)}

    def loss_of(p, b):
        return M.loss_fn(cfg, p, b)

    one = _local_grads_and_loss(TrainConfig(), loss_of, params, batch)
    two = _local_grads_and_loss(TrainConfig(microbatch=2), loss_of, params, batch)
    assert float(two[0]) == pytest.approx(float(one[0]), abs=1e-6)
    for a, b in zip(tree_leaves(two[2]), tree_leaves(one[2])):
        b = b.float()
        assert float((a.float() - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-12
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32), "positions": jnp.asarray(pos, jnp.int32)}
    with pytest.raises(TypeError):
        jstep._grads_and_loss(JTrainConfig(microbatch=2), None, None, jbatch)


# ---------------------------------------------------------------------------
# the kernel wrappers' shape-only launches
# ---------------------------------------------------------------------------


def _fused_args(side, shape, q8, p4, device):
    L, m, r, n = shape
    kept, mv = ((m, r), (r, n)) if side == "left" else ((n, r), (m, r))
    P = torch.linalg.qr(torch.randn(L, *kept))[0].contiguous()
    if p4:
        P = codec.quant4_axis_state(P)
    G = torch.randn(L, m, n)
    W = torch.randn(L, m, n)
    if q8:
        ax = -1 if side == "left" else -2
        mom = [*codec.quantize_axis(torch.zeros(L, *mv), axis=ax, signed=True),
               *codec.quantize_axis(torch.zeros(L, *mv), axis=ax, signed=False)]
    else:
        mom = [torch.zeros(L, *mv), torch.zeros(L, *mv)]
    to = (lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")) if device == "meta" else (
        lambda t: t)
    P = {k: to(v) for k, v in P.items()} if p4 else to(P)
    return P, to(G), to(W), [to(t) for t in mom], to(torch.tensor(3, dtype=torch.int32)), to(
        torch.tensor([-1e-3]))


@pytest.mark.parametrize("name", [fn.__name__ for fn in tk.WRAPPERS])
@pytest.mark.parametrize("p4", [False, True])
def test_fused_wrappers_shape_only_launch(name, p4):
    """Each of galore_epilogue's eight wrappers on meta tensors: the CUDA
    branch's outputs (G̃ (L, m, n) f32 for an emit form; W, codes and
    moments returned as the same objects), no launch counted, one
    meta_launch and the contractions' 4·L·m·r·n flops."""
    fn = getattr(tk, name)
    side = "right" if name.endswith("_right") else "left"
    q8, apply = "adam8" in name, "apply" in name
    shape = (2, 72, 16, 130) if side == "left" else (2, 130, 16, 72)
    outs = []
    for dev in ("cpu", "meta"):
        P, G, W, mom, count, eta = _fused_args(side, shape, q8, p4, dev)
        kw = dict(eta=eta) if apply else {}
        args = (P, G, W, *mom, count) if apply else (P, G, *mom, count)
        tk.reset_launch_counts()
        meta.reset()
        out = fn(*args, alpha=0.25, **kw)
        assert fn.launches == 0 and getattr(fn, "launches_int4", 0) == 0
        assert fn.meta_launches == (dev == "meta")
        if dev == "meta":
            assert meta.kernel_flops() == 4 * math.prod(shape)
            held = (W, *mom) if apply else tuple(mom)
            assert all(a is b for a, b in zip(out[len(out) - len(held):], held))
        outs.append([(t.shape, t.dtype) for t in out])
    assert outs[0] == outs[1]


def test_projection_flat_adam_and_rmsnorm_shape_only_launches():
    """B4, B5, the flat 8-bit Adam and RMSNorm on meta tensors: the CPU
    outputs' shapes and dtypes, no launch, one meta_launch each."""
    L, m, r, n = 2, 72, 16, 130
    cpu = dict(P=torch.randn(L, m, r), G=torch.randn(L, m, n).bfloat16(), N=torch.randn(L, r, n),
               g=torch.randn(1000).bfloat16(), x=torch.randn(3, 5, 64).bfloat16(),
               s=torch.ones(64))
    nb = -(-1000 // codec.BLOCK)
    mom = dict(mq=torch.zeros(nb, codec.BLOCK, dtype=torch.uint8), ms=torch.ones(nb),
               vq=torch.zeros(nb, codec.BLOCK, dtype=torch.uint8), vs=torch.ones(nb),
               c=torch.tensor(2, dtype=torch.int32))
    calls = [(tp.galore_project, lambda t: (t["P"], t["G"])),
             (tp.galore_project_back, lambda t: (t["P"], t["N"], 0.25)),
             (a8.adam8bit_update, lambda t: (t["g"], t["mq"], t["ms"], t["vq"], t["vs"], t["c"])),
             (trms.rmsnorm, lambda t: (t["x"], t["s"]))]
    for fn, args in calls:
        got = []
        for dev in ("cpu", "meta"):
            t = {k: v.clone() if dev == "cpu" else torch.empty(v.shape, dtype=v.dtype,
                                                               device="meta")
                 for k, v in {**cpu, **mom}.items()}
            meta.reset()
            before = fn.launches
            out = fn(*args(t))
            assert fn.launches == before and fn.meta_launches == (dev == "meta")
            outs = out if isinstance(out, tuple) else (out,)
            got.append([(o.shape, o.dtype) for o in outs])
        assert got[0] == got[1], fn.__name__
    meta.reset()
    tp.galore_project(*[torch.empty(x.shape, dtype=x.dtype, device="meta")
                        for x in (cpu["P"], cpu["G"])])
    assert meta.kernel_flops() == 2 * L * m * r * n


def test_meta_route_matches_the_cpu_route_launch_for_launch():
    """A fused GaLore step on meta at llama_60m smoke: one shape-only launch
    of the fp32 emit kernels a GaLore leaf (left and right), none counted
    as a launch."""
    cfg = get_config("llama_60m", smoke=True)
    tc = TrainConfig(optimizer="adamw", galore_fused_adam=True,
                     galore=GaLoreConfig(rank=8, update_freq=2))
    tk.reset_launch_counts()
    rec = dryrun.dry_run_step(cfg, tc, 4, 32, "train")
    assert all(fn.launches == 0 for fn in tk.WRAPPERS)
    assert rec["kernels"] == {"galore_fused_adam_step": 6, "galore_fused_adam_step_right": 1}
    assert rec["refresh"]["kernels"] == rec["kernels"]


# ---------------------------------------------------------------------------
# run_cell, the CLI and hillclimb
# ---------------------------------------------------------------------------


SMALL = {name: dataclasses.replace(c, seq_len=64 if c.kind != "decode" else 128, global_batch=2)
         for name, c in SHAPES.items()}


@pytest.mark.parametrize("arch", list(J_ARCH_IDS))
def test_run_cell_records_every_arch_at_smoke_size(arch, monkeypatch):
    """Every shape of every arch at smoke size (the cells cut to 2 × 64, decode
    caches of 128): "skipped" exactly where the reference's supports_shape
    says, with its reason, else "ok" with the reference's record keys."""
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    monkeypatch.setattr(dryrun, "get_config", lambda name: get_config(name, smoke=True))
    for shape in J_SHAPES:
        ok, reason = jax_get_config(arch).supports_shape(shape)
        rec = dryrun.run_cell(arch, shape)
        if not ok:  # the reason in the port's words (no DESIGN.md here)
            assert rec["status"] == "skipped" and reason.startswith(rec["reason"])
            continue
        assert rec["status"] == "ok", rec
        mem = rec["memory"]
        assert mem["peak_bytes_per_device"] == mem["argument_bytes"] + mem["temp_bytes"] > 0
        assert rec["hbm_ok"] and rec["raw_cost"]["flops"] > 0
        assert rec["useful_flops_ratio"] == rec["model_flops_per_device"] / rec["raw_cost"]["flops"]
        if SHAPES[shape].kind == "train":
            assert rec["refresh"]["peak_bytes_per_device"] > 0 and rec["refresh"]["flops"] > 0


def test_cli_resumes_and_force_recomputes(tmp_path, capsys):
    out = tmp_path / "dry.json"
    argv = ["--arch", "qwen2_7b", "--shape", "decode_32k", "long_500k", "--out", str(out)]
    dryrun.main(argv)
    first = json.loads(out.read_text())
    assert {r["status"] for r in first.values()} == {"ok", "skipped"}
    capsys.readouterr()
    dryrun.main(argv)
    assert capsys.readouterr().out.count("[dryrun] cached") == 2
    first[dryrun.cell_key("qwen2_7b", "decode_32k", None)]["memory"] = "stale"
    out.write_text(json.dumps(first))
    dryrun.main(argv + ["--force"])
    again = json.loads(out.read_text())
    assert again[dryrun.cell_key("qwen2_7b", "decode_32k", None)]["memory"] != "stale"
    with pytest.raises(SystemExit):  # the port counts at full depth
        dryrun.main(argv + ["--skip-scaling"])
    mesh_out = tmp_path / "mesh.json"
    dryrun.main(["--arch", "qwen2_7b", "--shape", "decode_32k", "--mesh", "single", "--rules",
                 "baseline", "--out", str(mesh_out)])
    rec = json.loads(mesh_out.read_text())[dryrun.cell_key("qwen2_7b", "decode_32k", None,
                                                           "single", "baseline")]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["memory"]["peak_bytes_per_device"] < again[dryrun.cell_key(
        "qwen2_7b", "decode_32k", None)]["memory"]["peak_bytes_per_device"]


def test_sharded_dry_run_of_llama_7b_on_a_fake_pod():
    """llama_7b's train_4k cell (2 of its 32 layers) as rank 0 of a fake
    16 × 16 world: a peak and collectives of every kind DTensor issues,
    counted; without FSDP (no_fsdp) a rank holds more parameter bytes than
    under baseline; the fake world is gone afterwards."""
    import torch.distributed as dist

    cut = {"n_layers": 2}
    base = dryrun.run_mesh_cell("llama_7b", "train_4k", overrides=cut)
    tp = dryrun.run_mesh_cell("llama_7b", "train_4k", rules_name="no_fsdp", overrides=cut)
    assert not dist.is_initialized()
    for rec in (base, tp):
        assert rec["status"] == "ok" and rec["memory"]["peak_bytes_per_device"] > 0
        counts = rec["collective_schedule"]["count_by_kind"]
        assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
        assert rec["collective_schedule"]["total_bytes"] > 0
        assert rec["refresh"]["collective_bytes"] > 0
        assert rec["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
        assert rec["model_flops_per_device"] == rec["model_flops_global"] / 256
    assert tp["memory"]["argument_bytes"] > base["memory"]["argument_bytes"]
    with dryrun.fake_world(256):
        from repro_torch.launch import mesh as tmesh

        m = tmesh.make_production_mesh(device_type="cuda")
        cfg = dataclasses.replace(get_config("llama_7b"), **cut)
        bytes_ = [sum(x.to_local().numel() * x.element_size()
                      for x in tree_leaves(input_specs(cfg, "train_4k",
                                                       dryrun.default_train_config(cfg),
                                                       tmesh.rules_variant(m, v))["params"]))
                  for v in ("baseline", "no_fsdp")]
    assert bytes_[1] > bytes_[0]
    assert not dist.is_initialized()


def test_cli_runs_with_no_card_and_no_jax(tmp_path):
    """python -m repro_torch.launch.dryrun in a fresh process: a record, and
    no jax (nor the JAX package) among the loaded modules."""
    out = tmp_path / "dry.json"
    code = ("import runpy, sys; sys.argv = ['dryrun', '--arch', 'mamba2_130m', '--shape', "
            f"'decode_32k', '--out', {str(out)!r}]; "
            "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__'); "
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))]")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    rec = json.loads(out.read_text())
    assert [r["status"] for r in rec.values()] == ["ok"]


def test_hillclimb_overrides(tmp_path, monkeypatch):
    """--set casts ints and floats and replaces ModelConfig fields (fewer
    layers: fewer bytes); microbatch sets the accumulation; the record
    carries the tag and overrides; --rules takes the six variants (on the
    pod's mesh) and nothing else."""
    assert hillclimb.parse_overrides(["n_layers=2", "rope_theta=1e5", "remat=full"]) == {
        "n_layers": 2, "rope_theta": 1e5, "remat": "full"}
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    out = str(tmp_path / "perf.json")
    base = hillclimb.main(["--arch", "qwen2_7b", "--shape", "decode_32k", "--tag", "base",
                           "--out", out])
    cut = hillclimb.main(["--arch", "qwen2_7b", "--shape", "decode_32k", "--tag", "cut",
                          "--set", "n_layers=2", "--out", out])
    assert cut["overrides"] == {"n_layers": 2}
    assert (cut["memory"]["peak_bytes_per_device"]
            < base["memory"]["peak_bytes_per_device"])
    mb = hillclimb.main(["--arch", "qwen2_7b", "--shape", "train_4k", "--tag", "mb",
                         "--set", "n_layers=1", "microbatch=2", "--out", out])
    assert mb["microbatch"] == 2 and mb["overrides"] == {"n_layers": 1, "microbatch": 2}
    assert set(json.loads(open(out).read())) == {"qwen2_7b|decode_32k|base",
                                                 "qwen2_7b|decode_32k|cut",
                                                 "qwen2_7b|train_4k|mb"}
    with pytest.raises(SystemExit):  # not a variant
        hillclimb.main(["--arch", "qwen2_7b", "--shape", "decode_32k", "--tag", "x",
                        "--rules", "fsdp", "--out", out])
    tp = hillclimb.main(["--arch", "qwen2_7b", "--shape", "decode_32k", "--tag", "tp",
                         "--rules", "no_fsdp", "--set", "n_layers=2", "--out", out])
    assert tp["status"] == "ok" and (tp["mesh"], tp["rules"]) == ("16x16", "no_fsdp")


# ---------------------------------------------------------------------------
# activation checkpointing: the policies reckoned
# ---------------------------------------------------------------------------


def test_remat_policies_rank_in_peak_bytes_and_flops():
    """llama_60m smoke, an AdamW train step at 2 × 128 on meta tensors under
    each remat policy: the peak falls none > scores > names > full, and the
    FLOPs a step (the recompute counted) rise in that order, "names" below
    "full" (it replays only what its backward reads, C.31); one forward and
    backward alone (dry_run_grad) ranks its kept bytes alike."""
    tc = TrainConfig(optimizer="adamw", galore=None, grad_clip=1.0, weight_decay=0.0)
    recs = {p: dryrun.dry_run_step(dataclasses.replace(get_config("llama_60m", smoke=True),
                                                       remat=p), tc, 2, 128, "train")
            for p in ("none", "scores", "names", "full")}
    peaks = [recs[p]["peak_bytes"] for p in recs]
    flops = [recs[p]["flops"] for p in recs]
    assert peaks[0] > peaks[1] > peaks[2] > peaks[3], peaks
    assert flops[0] < flops[1] <= flops[2] < flops[3], flops
    kept = [dryrun.dry_run_grad(dataclasses.replace(get_config("llama_60m", smoke=True),
                                                    remat=p), 2, 128)["kept_bytes"]
            for p in recs]
    assert kept[0] > kept[1] > kept[2] > kept[3], kept


@pytest.mark.parametrize("arch", ["llama_60m", "llama_7b"])
def test_names_flops_are_none_s_plus_what_its_backward_reads(arch):
    """dry_run_grad at 2 of the arch's layers, 2 × 256 (meta tensors): the
    FLOPs under "names" are "none"'s plus, each layer, the products whose
    outputs the backward reads and no named tensor holds — QKᵀ (2·B·H·S²·hd),
    wo (2·B·S·H·hd·D), gate and up (2·B·S·D·F each) — and below "full"'s,
    which replays the q/k/v projections and PV too (ROADMAP C.31)."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    B, S = 2, 256
    H, hd, D, F = cfg.n_heads, cfg.resolved_head_dim, cfg.d_model, cfg.d_ff
    flops = {p: dryrun.dry_run_grad(dataclasses.replace(cfg, remat=p), B, S)["flops"]
             for p in ("none", "names", "full")}
    per_layer = 2 * B * H * S * S * hd + 2 * B * S * H * hd * D + 2 * 2 * B * S * D * F
    assert flops["names"] == flops["none"] + cfg.n_layers * per_layer
    pv_qkv = 2 * B * H * S * S * hd + 2 * B * S * D * (H + 2 * cfg.n_kv_heads) * hd
    assert flops["full"] == flops["names"] + cfg.n_layers * pv_qkv


def test_hillclimb_remat_scores_example(tmp_path):
    """The reference's own example, ``--arch qwen2_7b --shape train_4k --set
    remat=scores`` (full size, on meta tensors): a record with the override,
    more useful FLOPs than the config's own remat "full" recomputes."""
    rec = hillclimb.main(["--arch", "qwen2_7b", "--shape", "train_4k", "--tag", "scores_remat",
                          "--set", "remat=scores", "--out", str(tmp_path / "perf.json")])
    assert rec["status"] == "ok" and rec["overrides"] == {"remat": "scores"}
    assert get_config("qwen2_7b").remat == "full"
    assert 0.8 < rec["useful_flops_ratio"] < 1.0
