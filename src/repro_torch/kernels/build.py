"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC`` into a shared library with a plain C interface,
which ``ctypes`` loads. Libraries land in ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), named by a hash of the source, of
every local header it includes (``#include "…"``, followed through the
headers' own includes) and of the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as is.
Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}  # per-process cache of loaded libraries
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}  # and of their configured functions
_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, /usr/local/cuda/bin or PATH; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
                           "PATH); the CUDA toolkit is needed to build the kernels")
    return found


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the local headers it includes, transitively."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path not in found:
            found.append(path)
            includes = _LOCAL_INCLUDE.findall(path.read_bytes())
            todo += [path.parent / inc.decode() for inc in includes]
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _sources(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict[str, Path]:
    """Compile every listed source that has no up-to-date library, with one
    nvcc process per source, all started together. Returns name -> library
    path; the compiler's report (registers, shared memory, spills) is kept
    beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in names}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        so = targets[name]
        Path(str(so) + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]


def entry(name: str, symbol: str, argtypes):
    """The C function `symbol` of ``csrc/<name>.cu``, with its argument types
    set (every pointer a ``c_void_p``, so none is cut to 32 bits) and a
    ``cudaError_t`` result. Configured once per library and symbol, so a
    wrapper's call pays for no more than the lookup."""
    key = (name, symbol)
    if key not in _entries:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[key] = fn
    return _entries[key]
