"""numpy ⇄ torch bridge for parameter and optimizer-state trees (GaLore's
state with its adaptive schedule, the async refresh's pending buffer, and
the standalone 8-bit Adam's).

The trees are nested dicts keyed like the JAX package's (``np.asarray`` of
each leaf of a ``repro`` tree is a valid input), so a test can run the port on
exactly the reference's initial weights and optimizer state. bfloat16 leaves
travel as float32 numpy arrays out of torch (exact: every bf16 value is an
f32 value); a JAX bfloat16 array comes in as a bfloat16 tensor. Optimizer
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

    Reads ``step``, ``key``, ``proj``, ``inner`` {``m``, ``v``, ``count``}
    and, under adaptive T, ``schedule`` — the layout of the JAX ``galore``
    state, at any per-leaf ranks. ``step`` becomes a host int; ``key`` a
    uint32[2] CPU tensor, passed through untouched; ``count`` stays an int32
    tensor on `device`; the schedule's ``period`` and ``next`` become host
    ints and its ``overlap`` 0-d f32 tensors on `device`. Every other leaf
    keeps its dtype: f32 moments and projectors, bf16 projectors, and the
    uint8 codes and f32 scales of quantized leaves."""
    inner = state["inner"]

    def leaves(tree):
        return tree_map(lambda a: _to_tensor(a, device), tree)

    out = {
        "step": int(np.asarray(state["step"])),
        "key": _to_tensor(state["key"], "cpu", torch.uint32),
        "proj": leaves(state["proj"]),
        "inner": {"m": leaves(inner["m"]), "v": leaves(inner["v"]),
                  "count": _to_tensor(inner["count"], device, torch.int32)},
    }
    if "schedule" in state:
        out["schedule"] = _schedule_from_numpy(state["schedule"], device)
    return out


def galore_state_to_numpy(state):
    inner = state["inner"]
    out = {
        "step": np.asarray(state["step"], np.int32),
        "key": _to_numpy(state["key"]),
        "proj": tree_map(_to_numpy, state["proj"]),
        "inner": {"m": tree_map(_to_numpy, inner["m"]), "v": tree_map(_to_numpy, inner["v"]),
                  "count": _to_numpy(inner["count"]).astype(np.int32)},
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


def adam8bit_state_from_numpy(state, device):
    """scale_by_adam8bit's state {"mv": {leaf: {"m", "v"}}, "count"} from its
    numpy form: quantized moments keep their uint8 codes and f32 scales,
    fp32 moments stay f32, and ``count`` is an int32 tensor on `device`."""
    return {"mv": tree_map(lambda a: _to_tensor(a, device), state["mv"]),
            "count": _to_tensor(state["count"], device, torch.int32)}


def adam8bit_state_to_numpy(state):
    return {"mv": tree_map(_to_numpy, state["mv"]),
            "count": _to_numpy(state["count"]).astype(np.int32)}
