"""Atomic, crc-checked, optionally async and quantized checkpoints (port of
repro/checkpoint/manager.py, in its on-disk format).

Layout:  <root>/step_<N>/host_0.npz  +  <root>/step_<N>/META.json
A step directory is written under ``step_<N>.tmp_<pid>`` and renamed once
META.json (the commit marker, written last) is in it, so a kill mid-save
never corrupts the latest checkpoint; ``latest_step`` trusts only directories
holding META.json, and a new manager removes tmp litter.

The format is the reference's, so a checkpoint written by either package
restores in the other: entries are named by the leaf's dotted path
(``opt_state.1.inner.m.blocks.attn.wq``, utils.path_str), bf16 leaves are
widened to f32 in the npz with their saved dtype in META ``dtypes``, a host
int (the galore ``step``) is saved as int32, and META carries the top-level
``groups`` and, with ``checksum``, each npz's crc32. Quantized checkpoints
(``quantize="int8"|"int4"``) store large float ``params.`` leaves as
blockwise codes + per-block scales (``<key>::q`` / ``<key>::scale``) with
separate crc32s, checked on every restore; that codec is lossy, everything
else round-trips bit for bit.

`save` copies every leaf to host numpy before it returns (a blocking copy,
never ``non_blocking``): the train step updates params and moments in place,
so the writer thread may only ever see those copies. numpy and the standard
library do the rest.

In a data-parallel world every rank calls ``save`` and ``restore``; only
the ``writer`` (rank 0) writes. Under GaLore-ZeRO (``zero``: the state's
``ZeroLayout`` and the galore state's index in the chain) ``save`` gathers
the ranks' blocks to the full layout first, so the file is the reference's,
readable by either package at any n_dp, and ``restore`` reads the full
state and cuts it into this world's blocks: a checkpoint saved by n ranks
resumes on any other number (elastic restore).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zipfile
import zlib

import numpy as np
import torch

from repro_torch.distributed.state_sharding import gather_opt_state, shard_opt_state
from repro_torch.utils import tree_leaves_with_path, tree_unflatten_like

# committed step dirs are exactly step_XXXXXXXX; save tmps are
# step_XXXXXXXX.tmp_<pid> (never eligible for restore, GC'd on init)
_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_RE = re.compile(r"^step_\d{8}\.tmp")

# file-codec specs: block length and max code magnitude (int4 uses short
# 64-element blocks to keep the per-block error small on heavy-tailed blocks)
_QUANT_SPECS = {"int8": (256, 127), "int4": (64, 7)}
# leaves smaller than this stay f32 verbatim (norm scales, biases)
MIN_QUANT_SIZE = 4096
_QPREFIX = "params."


def _np_quantize(arr: np.ndarray, codec: str):
    """f32 ndarray -> (codes, scales) in the flat blockwise file codec."""
    block, qmax = _QUANT_SPECS[codec]
    flat = np.ascontiguousarray(arr, dtype=np.float32).ravel()
    pad = (-flat.size) % block
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.float32)])
    blocks = flat.reshape(-1, block)
    scale = (np.max(np.abs(blocks), axis=1) / qmax + 1e-12).astype(np.float32)
    q = np.clip(np.rint(blocks / scale[:, None]), -qmax, qmax).astype(np.int8)
    if codec == "int4":
        u = (q.astype(np.int16) + qmax).astype(np.uint8)  # [0, 14]
        half = block // 2
        return (u[:, :half] | (u[:, half:] << 4)).astype(np.uint8), scale
    return q, scale


def _np_dequantize(q: np.ndarray, scale: np.ndarray, codec: str, shape):
    block, qmax = _QUANT_SPECS[codec]
    if codec == "int4":
        u = q.astype(np.int16)
        blocks = np.concatenate([u & 0xF, u >> 4], axis=1).astype(np.float32) - qmax
    else:
        blocks = q.astype(np.float32)
    flat = (blocks * scale[:, None].astype(np.float32)).ravel()
    n = int(np.prod(shape)) if shape else 1
    return flat[:n].reshape(shape)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _family(name: str) -> str:
    """float (f32, bf16, …) or int (signed, unsigned, bool)."""
    return "float" if name.startswith(("float", "bfloat")) else "int"


def _host_copy(leaf):
    """(numpy copy, saved dtype name) of one leaf. A CUDA tensor comes over
    by a blocking copy; a CPU tensor is cloned, so later in-place updates
    never reach the copy; bf16 is widened to f32 (exact)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _dtype_name(t.dtype)
        if t.dtype == torch.bfloat16:
            t = t.to("cpu").float()
        elif t.device.type == "cpu":
            t = t.clone()
        else:
            t = t.to("cpu")
        return t.numpy(), name
    if isinstance(leaf, (bool, np.bool_)) or not isinstance(leaf, (int, np.integer)):
        raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")
    return np.asarray(leaf, np.int32), "int32"  # a host step counter (JAX: int32)


def _flatten(tree):
    arrays, dtypes = {}, {}
    for key, leaf in tree_leaves_with_path(tree):
        arrays[key], dtypes[key] = _host_copy(leaf)
    return arrays, dtypes


class CheckpointManager:
    """Atomic, optionally async + quantized checkpoints under one root dir.

    Parameters
    ----------
    root : str
        Checkpoint directory (created if missing; stale ``*.tmp_<pid>``
        litter from killed saves is removed on init).
    keep : int
        Newest committed steps retained; older ones are deleted after each
        successful save.
    async_save : bool
        Write on a daemon thread; a failure re-raises at the next
        ``wait()`` / ``save()``.
    checksum : bool
        Record each npz's crc32 in META (exact torn-file detection). Off by
        default, as the reference's; validation then reads the zip's own
        member CRCs.
    quantize : {None, "int8", "int4"}
        File codec for large float ``params.`` leaves; restore is
        META-driven, so quantized and plain steps coexist in one root.
    writer : bool
        Whether this process writes (rank 0 of a data-parallel world; the
        other ranks take part in the ZeRO gather only).
    """

    def __init__(self, root: str, keep: int = 3, async_save: bool = True,
                 checksum: bool = False, quantize: str | None = None, writer: bool = True):
        if quantize not in (None, "int8", "int4"):
            raise ValueError(f"quantize must be None, 'int8' or 'int4', got {quantize!r}")
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self.checksum = checksum
        self.quantize = quantize
        self.writer = writer
        self._thread: threading.Thread | None = None
        self._save_exc: BaseException | None = None
        os.makedirs(root, exist_ok=True)
        # init is launcher start-up, so no save of this root is in flight
        for name in (os.listdir(root) if writer else ()):
            if _TMP_RE.match(name):
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, extra_meta: dict | None = None, block: bool = False,
             zero=None):
        """Commit `tree` as the checkpoint for `step`.

        Every leaf is copied to the host before this returns; the write
        happens on a daemon thread unless `block` or ``async_save=False``.
        A top-level dict records its sorted keys as META ``groups``;
        `extra_meta` is merged into META.json verbatim. `zero` (layout,
        index): tree["opt_state"] holds this rank's ZeRO blocks, gathered
        here (a collective: every rank calls save)."""
        if zero is not None:
            tree = dict(tree, opt_state=gather_opt_state(tree["opt_state"], zero[1], zero[0]))
        if not self.writer:
            return
        arrays, dtypes = _flatten(tree)
        meta = {"step": step, "time": time.time(), "dtypes": dtypes, **(extra_meta or {})}
        if self.quantize is not None:
            # before the thread starts: the writer only ever sees numpy copies
            arrays, qmeta = self._quantize_arrays(arrays)
            if qmeta:
                meta["quant"] = qmeta
        if isinstance(tree, dict):
            meta.setdefault("groups", sorted(tree.keys()))
        if self.async_save and not block:
            self.wait()  # never two saves at once; re-raises a prior failure
            self._thread = threading.Thread(target=self._write_guarded,
                                            args=(step, arrays, meta), daemon=True)
            self._thread.start()
        else:
            self.wait()
            self._write(step, arrays, meta)

    def _quantize_arrays(self, arrays: dict):
        """Replace eligible f32 entries (``params.`` leaves of ≥ MIN_QUANT_SIZE
        elements) with <key>::q / <key>::scale pairs and their META records."""
        out, qmeta = {}, {}
        for key, arr in arrays.items():
            if key.startswith(_QPREFIX) and arr.dtype.kind == "f" and arr.size >= MIN_QUANT_SIZE:
                q, scale = _np_quantize(arr, self.quantize)
                out[key + "::q"] = q
                out[key + "::scale"] = scale
                qmeta[key] = {"codec": self.quantize, "block": _QUANT_SPECS[self.quantize][0],
                              "shape": list(arr.shape), "crc_q": _crc(q),
                              "crc_scale": _crc(scale)}
            else:
                out[key] = arr
        return out, qmeta

    def _write_guarded(self, step: int, arrays: dict, meta: dict):
        # the thread's failure is kept for the next wait()/save(): the run must
        # not go on training while it silently writes no checkpoints
        try:
            self._write(step, arrays, meta)
        except BaseException as e:  # noqa: BLE001 - re-raised on the main thread
            self._save_exc = e

    def _write(self, step: int, arrays: dict, meta: dict):
        final = os.path.join(self.root, f"step_{step:08d}")
        tmp = final + f".tmp_{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "host_0.npz"), **arrays)  # one process: host 0
        if self.checksum:
            sums = {}
            for name in sorted(os.listdir(tmp)):
                if name.endswith(".npz"):
                    sums[name] = _file_crc(os.path.join(tmp, name))
            meta = {**meta, "checksums": sums}
        with open(os.path.join(tmp, "META.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def wait(self):
        """Join any in-flight async save; re-raise its failure if it died."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self._save_exc is not None:
            exc, self._save_exc = self._save_exc, None
            raise RuntimeError("async checkpoint save failed") from exc

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"), ignore_errors=True)

    # -- load ---------------------------------------------------------------

    def all_steps(self) -> list[int]:
        """Sorted committed steps (directories with a META.json) under root."""
        out = []
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name, "META.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        """Newest committed step, or None when the root is empty."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def valid_step(self, step: int) -> bool:
        """True if the checkpoint at `step` passes its integrity checks: META
        parses, a host npz exists, and every npz matches its recorded crc32
        (or, saved without checksums, the zip's own member CRCs)."""
        path = os.path.join(self.root, f"step_{step:08d}")
        try:
            meta = self.meta(step)
        except (FileNotFoundError, json.JSONDecodeError):
            return False
        sums = meta.get("checksums")
        npz = [n for n in sorted(os.listdir(path)) if n.endswith(".npz")]
        if not npz:
            return False
        for name in npz:
            fpath = os.path.join(path, name)
            try:
                if sums is not None:
                    if name not in sums or _file_crc(fpath) != sums[name]:
                        return False
                else:
                    with zipfile.ZipFile(fpath) as z:
                        if z.testzip() is not None:
                            return False
            except (OSError, zipfile.BadZipFile):
                return False
        return True

    def latest_valid_step(self) -> int | None:
        """Newest step that passes valid_step — a rollback's target. A torn
        latest checkpoint degrades to the one before it."""
        for s in reversed(self.all_steps()):
            if self.valid_step(s):
                return s
        return None

    def meta(self, step: int) -> dict:
        """Parsed META.json for `step` (raises FileNotFoundError if absent)."""
        with open(os.path.join(self.root, f"step_{step:08d}", "META.json")) as f:
            return json.load(f)

    def groups(self, step: int) -> tuple:
        """Top-level keys of the tree saved at `step` (() for checkpoints
        without groups), so a resume can choose its restore target."""
        return tuple(self.meta(step).get("groups", ()))

    def restore(self, step: int, target_tree, zero=None):
        """The checkpoint at `step`, in the structure of `target_tree`.

        Each tensor leaf comes back as a new tensor of the target leaf's
        dtype, device and ``requires_grad``; a host int leaf as an int.
        Quantized file-codec leaves are dequantized through META after their
        crc32s pass (whatever `checksum` says); a leaf whose saved dtype is
        of the other family (float vs integer) than the target's, or whose
        shape differs, raises: quantized and fp32 state layouts never cast
        silently into one another. `zero` (layout, index), as save's: the
        file holds the full layout, which is cut into this rank's blocks."""
        if zero is not None:
            full = dict(target_tree, opt_state=gather_opt_state(target_tree["opt_state"],
                                                                zero[1], zero[0]))
            out = self.restore(step, full)
            return dict(out, opt_state=shard_opt_state(out["opt_state"], zero[1], zero[0]))
        path = os.path.join(self.root, f"step_{step:08d}")
        data = {}
        for name in os.listdir(path):
            if name.endswith(".npz"):
                with np.load(os.path.join(path, name)) as z:
                    data.update({k: z[k] for k in z.files})
        try:
            meta = self.meta(step)
        except FileNotFoundError:
            meta = {}
        saved_dtypes = meta.get("dtypes", {})
        for key, spec in meta.get("quant", {}).items():
            q = data.pop(key + "::q", None)
            scale = data.pop(key + "::scale", None)
            if q is None or scale is None:
                raise KeyError(f"quantized checkpoint leaf {key} is missing its codes/scales "
                               f"entries")
            for what, arr, want in (("codes", q, spec["crc_q"]),
                                    ("scales", scale, spec["crc_scale"])):
                if _crc(arr) != want:
                    raise ValueError(f"quantized {what} of checkpoint leaf {key} failed their "
                                     f"crc32 — the file is corrupt; roll back to an earlier step")
            data[key] = _np_dequantize(q, scale, spec["codec"], tuple(spec["shape"]))

        out = []
        for key, leaf in tree_leaves_with_path(target_tree):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.asarray(data[key])
            want = _dtype_name(leaf.dtype) if isinstance(leaf, torch.Tensor) else "int32"
            saved = saved_dtypes.get(key)
            if saved is not None and _family(saved) != _family(want):
                raise ValueError(
                    f"checkpoint leaf {key} was saved as {saved} but the target tree expects "
                    f"{want} — quantized and fp32 state layouts are not interchangeable "
                    f"(rebuild the state with the matching QuantPolicy)")
            if not isinstance(leaf, torch.Tensor):
                out.append(int(arr))
                continue
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key} has shape {arr.shape}, the target "
                                 f"{tuple(leaf.shape)}")
            t = torch.from_numpy(arr).to(leaf.dtype).to(leaf.device)
            out.append(t.requires_grad_(True) if leaf.requires_grad else t)
        return tree_unflatten_like(target_tree, out)


def _file_crc(path: str) -> int:
    """crc32 of a whole file, read in 64 MiB pieces."""
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 26):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF
