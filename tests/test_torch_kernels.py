"""Port kernels: the plain versions of the fused GaLore-Adam step against the
JAX package's Pallas kernels (interpret mode), and the port's independence
from JAX. The kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import galore_fused as tk  # noqa: E402
from test_torch_cuda import SHAPES, adam8_inputs, assert_close, fused_inputs  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(shape, side, dtype):
    """The port's plain versions == the Pallas kernels run in interpret mode,
    to 1e-5·max on G̃, M' and V' (both compute in f32 from the same inputs)."""
    P, G, M, V = fused_inputs(shape, side)
    jfn = jops.galore_fused_adam_step if side == "left" else jops.galore_fused_adam_step_right
    tfn = tk.galore_fused_adam_step if side == "left" else tk.galore_fused_adam_step_right
    want = jfn(jnp.asarray(P), jnp.asarray(G).astype(dtype), jnp.asarray(M), jnp.asarray(V),
               jnp.int32(7), alpha=0.25, use_pallas=True, interpret=True)
    Gt = torch.from_numpy(G).to(getattr(torch, dtype))
    Mt, Vt = torch.from_numpy(M.copy()), torch.from_numpy(V.copy())
    got = tfn(torch.from_numpy(P), Gt, Mt, Vt, torch.tensor(7, dtype=torch.int32), alpha=0.25)
    assert got[1] is Mt and got[2] is Vt  # moments are updated in place
    for name, a, b in zip(["update", "m", "v"], got, want):
        assert_close(a, b, f"{side} {shape} {dtype} {name}")


def test_cpu_wrapper_does_not_count_launches():
    tk.reset_launch_counts()
    P, G, M, V = (torch.from_numpy(a) for a in fused_inputs((64, 16, 48), "left"))
    tk.galore_fused_adam_step(P, G, M, V, torch.tensor(1, dtype=torch.int32))
    assert tk.galore_fused_adam_step.launches == 0


def test_reset_launch_counts_zeroes_every_counter():
    """ops.reset_launch_counts zeroes every wrapper's counters, the thread-copy
    counts of galore_epilogue's kernel (int8 moments and the fp32-moment
    apply form) among them; the plain versions on CPU tensors count
    nothing."""
    from repro_torch.kernels import adam8bit_update, galore_project, ops, rmsnorm
    counted = [(fn, "launches") for fn in tk.WRAPPERS]
    counted += [(fn, "launches_int4") for fn in tk.WRAPPERS[:2] + tk.WRAPPERS[4:6]]
    counted += [(fn, "launches_thread_copy") for fn in tk.WRAPPERS_TMA]
    counted += [(fn, "launches") for fn in (adam8bit_update.adam8bit_update,
                                            galore_project.galore_project,
                                            galore_project.galore_project_back, rmsnorm.rmsnorm)]
    counted += [(fn, "launches_thread_copy") for fn in (galore_project.galore_project,
                                                        galore_project.galore_project_back)]
    assert set(tk.WRAPPERS_TMA) == {tk.galore_fused_adam8_step, tk.galore_fused_adam8_step_right,
                                    tk.galore_fused_adam8_apply_step,
                                    tk.galore_fused_adam8_apply_step_right,
                                    tk.galore_fused_adam_apply_step,
                                    tk.galore_fused_adam_apply_step_right}
    for fn, attr in counted:
        setattr(fn, attr, 3)
    ops.reset_launch_counts()
    assert all(getattr(fn, attr) == 0 for fn, attr in counted)
    P, G, moments = adam8_inputs((72, 16, 130), "left")
    tk.galore_fused_adam8_step(torch.from_numpy(P), torch.from_numpy(G),
                               *[torch.from_numpy(t.copy()) for t in moments],
                               torch.tensor(7, dtype=torch.int32))
    assert all(getattr(fn, attr) == 0 for fn, attr in counted)


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """Nothing under src/repro_torch/, nor chip_smoke.py, imports jax or the
    JAX package."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    port = ROOT / "src" / "repro_torch"
    for module in ("quant/codec.py", "quant/policy.py", "launch/cli.py", "kernels/galore_fused.py",
                   "optim/adam8bit.py", "optim/quant8.py", "kernels/adam8bit_update.py",
                   "kernels/galore_project.py", "kernels/rmsnorm.py", "kernels/ops.py"):
        assert port / module in files, module
    bad = [
        f"{f.relative_to(ROOT)}: {mod}"
        for f in files for mod in _imported_modules(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, bad


def test_build_digest_follows_local_headers(tmp_path, monkeypatch):
    """A library is named by the digest of its source and of every local
    header the source includes (transitively), so an edited header rebuilds
    it; a system header (<...>) is not read. Needs no nvcc."""
    # the int4 P decode is shared by both GaLore-Adam kernels, the split-TF32
    # wgmma and TMA pieces by the int8-moment kernel and the tiled projections
    assert {p.name for p in build._sources("galore_fused")} == {"galore_fused.cu", "int4_p.cuh"}
    assert {p.name for p in build._sources("galore_epilogue")} == {
        "galore_epilogue.cu", "int4_p.cuh", "tf32_wgmma.cuh"}
    assert {p.name for p in build._sources("galore_project")} == {
        "galore_project.cu", "tf32_wgmma.cuh"}
    assert [p.name for p in build._sources("rmsnorm")] == ["rmsnorm.cu"]  # no local header
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int b = 1;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert sorted(p.name for p in build._sources("k")) == ["a.cuh", "b.cuh", "k.cu"]
    before = build._target("k")
    (tmp_path / "b.cuh").write_text("int b = 2;\n")
    after = build._target("k")
    assert after != before and after.name.startswith("k-")
    assert build._target("k") == after  # unchanged sources, unchanged name
