"""numpy ⇄ torch bridge for parameter and optimizer-state trees (GaLore's
state, and the standalone 8-bit Adam's).

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

    Reads ``step``, ``key``, ``proj`` and ``inner`` {``m``, ``v``,
    ``count``} — the layout of the JAX ``galore`` state. ``step`` becomes a
    host int; ``key`` a uint32[2] CPU tensor, passed through untouched;
    ``count`` stays an int32 tensor on `device`. Every other leaf keeps its
    dtype: f32 moments and projectors, bf16 projectors, and the uint8 codes
    and f32 scales of quantized leaves."""
    inner = state["inner"]

    def leaves(tree):
        return tree_map(lambda a: _to_tensor(a, device), tree)

    return {
        "step": int(np.asarray(state["step"])),
        "key": _to_tensor(state["key"], "cpu", torch.uint32),
        "proj": leaves(state["proj"]),
        "inner": {"m": leaves(inner["m"]), "v": leaves(inner["v"]),
                  "count": _to_tensor(inner["count"], device, torch.int32)},
    }


def galore_state_to_numpy(state):
    inner = state["inner"]
    return {
        "step": np.asarray(state["step"], np.int32),
        "key": _to_numpy(state["key"]),
        "proj": tree_map(_to_numpy, state["proj"]),
        "inner": {"m": tree_map(_to_numpy, inner["m"]), "v": tree_map(_to_numpy, inner["v"]),
                  "count": _to_numpy(inner["count"]).astype(np.int32)},
    }


def adam8bit_state_from_numpy(state, device):
    """scale_by_adam8bit's state {"mv": {leaf: {"m", "v"}}, "count"} from its
    numpy form: quantized moments keep their uint8 codes and f32 scales,
    fp32 moments stay f32, and ``count`` is an int32 tensor on `device`."""
    return {"mv": tree_map(lambda a: _to_tensor(a, device), state["mv"]),
            "count": _to_tensor(state["count"], device, torch.int32)}


def adam8bit_state_to_numpy(state):
    return {"mv": tree_map(_to_numpy, state["mv"]),
            "count": _to_numpy(state["count"]).astype(np.int32)}
