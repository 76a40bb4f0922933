"""Port kernels: the plain versions of the fused GaLore-Adam step against the
JAX package's Pallas kernels (interpret mode), and the port's independence
from JAX. The kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py."""
import ast
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import galore_fused as tk  # noqa: E402
from test_torch_cuda import SHAPES, adam8_inputs, assert_close, fused_inputs  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

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
    counts of galore_epilogue's kernel (every GaLore step form) among them;
    the plain versions on CPU tensors count nothing."""
    from repro_torch.kernels import adam8bit_update, galore_project, ops, rmsnorm
    counted = [(fn, "launches") for fn in tk.WRAPPERS]
    counted += [(fn, "launches_int4") for fn in tk.WRAPPERS[:2] + tk.WRAPPERS[4:6]]
    counted += [(fn, "launches_thread_copy") for fn in tk.WRAPPERS_TMA]
    counted += [(fn, "launches") for fn in (adam8bit_update.adam8bit_update,
                                            galore_project.galore_project,
                                            galore_project.galore_project_back, rmsnorm.rmsnorm)]
    counted += [(fn, "launches_thread_copy") for fn in (galore_project.galore_project,
                                                        galore_project.galore_project_back)]
    assert set(tk.WRAPPERS_TMA) == set(tk.WRAPPERS)
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
    """Nothing under src/repro_torch/, nor chip_smoke.py, the timers it
    takes from tools/kernel_times.py or tools/chip_phases.py, which runs
    some of its phases, imports jax or the JAX package."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "kernel_times.py",
        ROOT / "tools" / "chip_phases.py"]
    assert len(files) > 10
    port = ROOT / "src" / "repro_torch"
    for module in ("quant/codec.py", "quant/policy.py", "launch/cli.py", "kernels/galore_fused.py",
                   "optim/adam8bit.py", "optim/quant8.py", "kernels/adam8bit_update.py",
                   "kernels/galore_project.py", "kernels/rmsnorm.py", "kernels/ops.py",
                   "checkpoint/manager.py", "robust/guard.py", "robust/faults.py",
                   "robust/recovery.py", "serve/__init__.py", "serve/api.py",
                   "serve/kv_cache.py", "serve/engine.py", "launch/serve.py",
                   "models/moe.py", "models/rope.py", "models/attention.py",
                   "models/stacks.py", "configs/qwen2_7b.py", "configs/granite_20b.py",
                   "configs/internlm2_20b.py", "configs/minitron_4b.py",
                   "configs/qwen2_vl_7b.py", "configs/grok_1_314b.py",
                   "configs/llama4_scout_17b_a16e.py", "models/ssm.py",
                   "configs/mamba2_130m.py", "configs/jamba_1_5_large_398b.py",
                   "distributed/world.py", "distributed/state_sharding.py"):
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
    # the SIMT fp32-moment emit kernel is gone: galore_epilogue's kernel runs
    # every GaLore step form, and no name resolves to the deleted source
    assert not (build.CSRC / "galore_fused.cu").exists()
    with pytest.raises(FileNotFoundError):
        build._sources("galore_fused")
    # the int4 P decode and the split-TF32 wgmma and TMA pieces are shared by
    # galore_epilogue's GaLore kernel, the latter with the tiled projections
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


_EXTERN_C = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _exports():
    """{source name: {C symbol: parameter count}} of every ``extern "C"``
    definition in csrc/*.cu."""
    out = {}
    for path in sorted(build.CSRC.glob("*.cu")):
        out[path.stem] = {name: len([p for p in params.split(",") if p.strip()])
                          for name, params in _EXTERN_C.findall(path.read_text())}
    return out


def _entry_calls(path):
    """(source, symbol, argtypes length) of every ``build.entry(source, symbol,
    argtypes)`` call in a wrapper module. The source and the argtypes list
    are literals or module-level constants; a symbol that is a parameter of
    the enclosing function is read from every call of that function in the
    module (its string literal at that position)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    consts = {t.id: node.value for node in tree.body if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name)}
    value = lambda n: consts[n.id] if isinstance(n, ast.Name) and n.id in consts else n  # noqa: E731
    funcs = {f.name: f for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)}
    calls = [c for c in ast.walk(tree) if isinstance(c, ast.Call)]
    found = []
    for fname, f in funcs.items():
        for call in ast.walk(f):
            if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute)
                    and call.func.attr == "entry" and isinstance(call.func.value, ast.Name)
                    and call.func.value.id == "build"):
                continue
            src, sym, types = (value(a) for a in call.args)
            assert isinstance(src, ast.Constant) and isinstance(types, ast.List), (path, fname)
            if isinstance(sym, ast.Constant):
                symbols = [sym.value]
            else:  # a parameter of f: the literals its callers pass there
                pos = [a.arg for a in f.args.args].index(sym.id)
                symbols = [c.args[pos].value for c in calls
                           if isinstance(c.func, ast.Name) and c.func.id == fname]
                assert symbols and all(isinstance(s_, str) for s_ in symbols), (path, fname)
            found += [(src.value, s_, len(types.elts)) for s_ in symbols]
    return found


def test_every_wrapper_symbol_is_exported_by_its_source():
    """Every C symbol a wrapper passes to build.entry is an ``extern "C"``
    definition of the source it names, with as many parameters as the
    wrapper's argtypes list, and every definition is some wrapper's: the
    wiring that only a launch on the card would otherwise check. The
    fp32-moment emit steps come from galore_epilogue, and nothing names the
    deleted galore_fused source."""
    exports = _exports()
    assert "galore_fused" not in exports
    calls = [c for f in sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*.py"))
             for c in _entry_calls(f)]
    assert ("galore_epilogue", "galore_fused_adam_left", 20) in calls
    assert ("galore_epilogue", "galore_fused_adam_right", 20) in calls
    # and every export is some wrapper's: 11 of galore_epilogue, 3 of
    # galore_project, rmsnorm's one
    assert {(src, sym) for src, sym, _ in calls} == {
        (src, sym) for src, names in exports.items() for sym in names}
    for src, sym, n_types in calls:
        assert src in exports, f"{sym}: no csrc/{src}.cu"
        assert sym in exports[src], f"csrc/{src}.cu exports no {sym}"
        assert exports[src][sym] == n_types, (
            f"{src}.{sym} takes {exports[src][sym]} parameters, its wrapper passes {n_types}")


def test_every_galore_wrapper_counts_thread_copies():
    """All eight GaLore wrappers launch galore_epilogue's kernel, so all eight
    are in WRAPPERS_TMA and count the launches that copied by the threads;
    reset_launch_counts zeroes each count, and the fp32 emit steps on CPU
    tensors (their plain versions) add nothing to them."""
    from repro_torch.kernels import ops
    assert set(tk.WRAPPERS_TMA) == set(tk.WRAPPERS) and len(set(tk.WRAPPERS)) == 8
    for fn in tk.WRAPPERS:
        fn.launches_thread_copy = 5
    ops.reset_launch_counts()
    assert [fn.launches_thread_copy for fn in tk.WRAPPERS_TMA] == [0] * 8
    for side, fn in (("left", tk.galore_fused_adam_step), ("right", tk.galore_fused_adam_step_right)):
        shape = (64, 16, 48) if side == "left" else (48, 16, 64)
        P, G, M, V = (torch.from_numpy(a) for a in fused_inputs(shape, side))
        fn(P, G, M, V, torch.tensor(1, dtype=torch.int32))
        assert (fn.launches, fn.launches_int4, fn.launches_thread_copy) == (0, 0, 0)
