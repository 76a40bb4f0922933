"""numpy ⇄ torch bridge for parameter and optimizer-state trees (GaLore's
state with its adaptive schedule and any inner state, the async refresh's
pending buffer, the standalone 8-bit Adam's, Adafactor's, SGD's momentum
trace, and LoRA adaptors) and for the serving KV caches.

The trees are nested dicts keyed like the JAX package's (``np.asarray`` of
each leaf of a ``repro`` tree is a valid input), so a test can run the port on
exactly the reference's initial weights and optimizer state. bfloat16 leaves
travel as float32 numpy arrays out of torch (exact: every bf16 value is an
f32 value); a JAX bfloat16 array comes in as a bfloat16 tensor, and every
leaf keeps its own dtype and rank — the f32 MoE router inside a bf16 tree,
1-D QKV biases, (L, E, m, n) expert leaves and the GaLore state on them
((L, E, m, r) projectors, (L, E, r, n) moments). Optimizer
state leaves keep their dtype both ways, so a quantized leaf
``{"q": codes, "scale": absmax}`` crosses as uint8 codes and float32 scales.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import tree_map


def _to_tensor(a, device, dtype=None) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bf16 from a JAX array
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy: the port updates in place
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def params_from_numpy(tree, device):
    """numpy (or JAX) parameter tree -> tensors on `device` that require grad,
    in the leaves' own dtype."""
    return tree_map(lambda a: _to_tensor(a, device).requires_grad_(True), tree)


def params_to_numpy(params):
    return tree_map(_to_numpy, params)


def galore_state_from_numpy(state, device):
    """The galore transform's state from its numpy form.

    Reads ``step``, ``key``, ``proj``, ``inner`` (Adam's {``m``, ``v``,
    ``count``}, or any inner transform's state: ``state_from_numpy``) and,
    under adaptive T, ``schedule`` — the layout of the JAX ``galore`` state,
    at any per-leaf ranks. ``step`` becomes a host int; ``key`` a uint32[2]
    CPU tensor, passed through untouched; the schedule's ``period`` and
    ``next`` become host ints and its ``overlap`` 0-d f32 tensors on
    `device`. Every other leaf keeps its dtype: f32 moments and projectors,
    bf16 projectors, the uint8 codes and f32 scales of quantized leaves,
    and the int32 count on `device`."""
    out = {
        "step": int(np.asarray(state["step"])),
        "key": _to_tensor(state["key"], "cpu", torch.uint32),
        "proj": state_from_numpy(state["proj"], device),
        "inner": state_from_numpy(state["inner"], device),
    }
    if "schedule" in state:
        out["schedule"] = _schedule_from_numpy(state["schedule"], device)
    return out


def galore_state_to_numpy(state):
    out = {
        "step": np.asarray(state["step"], np.int32),
        "key": _to_numpy(state["key"]),
        "proj": state_to_numpy(state["proj"]),
        "inner": state_to_numpy(state["inner"]),
    }
    if "schedule" in state:
        out["schedule"] = _schedule_to_numpy(state["schedule"])
    return out


def _schedule_from_numpy(sched, device):
    return {"period": tree_map(lambda a: int(np.asarray(a)), sched["period"]),
            "next": tree_map(lambda a: int(np.asarray(a)), sched["next"]),
            "overlap": tree_map(lambda a: _to_tensor(a, device, torch.float32), sched["overlap"])}


def _schedule_to_numpy(sched):
    return {"period": tree_map(lambda x: np.asarray(x, np.int32), sched["period"]),
            "next": tree_map(lambda x: np.asarray(x, np.int32), sched["next"]),
            "overlap": tree_map(_to_numpy, sched["overlap"])}


def pending_from_numpy(pending, device):
    """The async refresh's pending buffer {"proj", "flag"[, "schedule"]}
    from its numpy (or JAX) form: projectors in their dtype on `device`,
    flags as host ints, the schedule as galore_state_from_numpy's."""
    out = {"proj": tree_map(lambda a: _to_tensor(a, device), pending["proj"]),
           "flag": tree_map(lambda a: int(np.asarray(a)), pending["flag"])}
    if "schedule" in pending:
        out["schedule"] = _schedule_from_numpy(pending["schedule"], device)
    return out


def pending_to_numpy(pending):
    out = {"proj": tree_map(_to_numpy, pending["proj"]),
           "flag": tree_map(lambda x: np.asarray(x, np.int32), pending["flag"])}
    if "schedule" in pending:
        out["schedule"] = _schedule_to_numpy(pending["schedule"])
    return out


def state_from_numpy(state, device):
    """Any optimizer state tree of tensors from its numpy (or JAX) form, each
    leaf in its own dtype on `device`: Adam's {m, v, count},
    scale_by_adam8bit's {"mv": {leaf: {"m", "v"}}, "count"} (uint8 codes and
    f32 scales), scale_by_adafactor's {"v": {vr, vc} | {v}, "count", "m"?},
    a momentum ``trace``'s f32 tree (its empty tuple too), and an
    int32 ``count`` stays int32."""
    return tree_map(lambda a: _to_tensor(a, device), state)


def state_to_numpy(state):
    return tree_map(_to_numpy, state)


def adaptors_from_numpy(adaptors, device):
    """A LoRA adaptor tree ({"A", "B"} f32 on each adapted leaf, a 0-d zero
    elsewhere; optim/lowrank.py) from its numpy (or JAX) form, A and B
    requiring grad, as ``init_adaptors`` makes them (``state_to_numpy``
    takes it back)."""

    def leaf(a):
        t = _to_tensor(a, device)
        return t.requires_grad_(True) if t.ndim >= 2 else t

    return tree_map(leaf, adaptors)


def cache_from_numpy(cache, device):
    """A KV cache from its numpy (or JAX) form — contiguous {"k", "v": (L, B,
    T, KV, hd)} or the paged pool {"kp", "vp": (L, NB, bs, KV, hd)} — in its
    own dtype on `device`, writable (the steps write it in place)."""
    return tree_map(lambda a: _to_tensor(a, device), cache)


def cache_to_numpy(cache):
    """Either KV cache as numpy (bf16 as f32, exact)."""
    return tree_map(_to_numpy, cache)
