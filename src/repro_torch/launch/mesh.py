"""The pod's meshes and its logical-axis sharding rules (port of
repro/launch/mesh.py).

Single pod:  (data=16, model=16)           — 256 ranks
Multi-pod:   (pod=2, data=16, model=16)    — 512 ranks; `pod` carries pure
                                             data parallelism.

The meshes are ``torch.distributed.DeviceMesh``es over the world that exists:
the caller starts it (``torch.distributed.init_process_group``, a real world
of processes or the dry run's fake one, launch/dryrun.py ``fake_world``).
The rule tables are the reference's, copied; a ``ShardingRules`` also takes a
``NamedShape`` (names and sizes, no ranks) where only specs are wanted.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils import ShardingRules, resolve_device

VARIANTS = ("baseline", "no_fsdp", "ep", "heads_tp", "no_seqshard_kv", "moe_local_dispatch")


@dataclasses.dataclass(frozen=True)
class NamedShape:
    """A mesh's dim names and sizes without ranks (the reference's
    ``AbstractMesh``): ``shape`` maps each name to its size."""

    sizes: tuple
    names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))


def production_shape(multi_pod: bool = False) -> NamedShape:
    if multi_pod:
        return NamedShape((2, 16, 16), ("pod", "data", "model"))
    return NamedShape((16, 16), ("data", "model"))


def _mesh(shape, names, device_type, ranks=None):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    device_type = device_type or resolve_device(None).type
    if ranks is None:
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))
    return DeviceMesh(device_type, torch.as_tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """The pod's mesh over a world of 256 (512 with `multi_pod`) ranks."""
    s = production_shape(multi_pod)
    return _mesh(s.sizes, s.names, device_type)


def make_host_mesh(device_type: str | None = None):
    """A (data=n, model=1) mesh over every rank of the world."""
    n = torch.distributed.get_world_size()
    return _mesh((n, 1), ("data", "model"), device_type)


def make_sim_mesh(n_dp: int, n_model: int = 1, device_type: str | None = None):
    """A (data=n_dp, model=n_model) mesh over the first n_dp·n_model ranks."""
    return _mesh((n_dp, n_model), ("data", "model"), device_type, ranks=range(n_dp * n_model))


def data_parallel_axes(rules: ShardingRules) -> tuple:
    """Mesh axis names carrying data parallelism (the `batch` rule)."""
    ax = rules.rules.get("batch")
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)


def data_parallel_size(rules: ShardingRules) -> int:
    """Number of data-parallel replicas (n_dp) under the rule set."""
    return rules.mesh_axis_size(rules.rules.get("batch"))


# ---------------------------------------------------------------------------
# Logical -> mesh axis rule sets (the reference's tables)
# ---------------------------------------------------------------------------


def default_rules(mesh, *, long_context: bool = False) -> ShardingRules:
    """FSDP×TP rules. Weights: TP dim ("heads_flat"/"ff"/"vocab"/"experts")
    on `model`, the other large dim ("embed") on `data` (ZeRO-3).
    Activations: batch on (pod, data), sequence on `model`. Long-context
    decode (batch 1) shards the KV cache's sequence on (data, model)."""
    has_pod = "pod" in ShardingRules(mesh, {}).mesh_shape
    batch_axes = ("pod", "data") if has_pod else ("data",)
    rules = {
        "batch": batch_axes,
        "act_seq": "model",
        "embed": "data",
        "ff": "model",
        "heads_flat": "model",
        "kv_flat": "model",
        "vocab": "model",
        "experts": None,
        "moe_cap": None,
        "layers": None,
        "rank_model": "model",
        "rank_data": "data",
        "qblocks": "data",
        "zero": batch_axes if len(batch_axes) > 1 else batch_axes[0],
        "kv_seq": ("data", "model") if long_context else "model",
        "kv_heads": None,
    }
    if long_context:
        rules["batch"] = None
    return ShardingRules(mesh=mesh, rules=rules)


def rules_variant(mesh, name: str, *, long_context: bool = False) -> ShardingRules:
    """The named rule variants of the reference's hillclimb."""
    rules = dict(default_rules(mesh, long_context=long_context).rules)
    if name == "baseline":
        pass
    elif name == "no_fsdp":  # pure TP: weights replicated across data
        rules["embed"] = None
    elif name == "ep":  # expert parallelism: experts on the model axis
        rules["experts"] = "model"
        rules["ff"] = None
    elif name == "heads_tp":  # Megatron head TP
        rules["act_seq"] = None
        rules["kv_heads"] = "model"
    elif name == "no_seqshard_kv":  # decode without context sharding
        rules["kv_seq"] = None
    elif name == "moe_local_dispatch":  # sequence replicated: shard-local routing
        rules["act_seq"] = None
    else:
        raise ValueError(f"unknown rules variant {name!r}")
    return ShardingRules(mesh=mesh, rules=rules)
