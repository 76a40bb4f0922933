"""Collective bytes and roofline terms of a sharded step, for the dry run
(port of repro/launch/hlo_analysis.py; the name is kept so that a reader
finds the counterpart — the port has no HLO).

The reference parses the compiled HLO text: each collective's result shape
and replica-group size give its operand bytes. The port records each
collective as the step issues it: DTensor lowers every redistribution to a
``_c10d_functional`` collective (or its own all-to-all) on the local
shards, and
``CollectiveRecorder`` (a dispatch mode under DTensor) notes its kind, the
mesh dim of its group and its operand bytes per device, by the reference's
definition (an all-gather's operand is its input, 1/g of the result; a
reduce-scatter's its input, g times the result; an all-reduce's and an
all-to-all's their input).

The reference also lowers every cell at one and two units of depth and
extrapolates (``depth_scale``), because XLA's cost analysis counts a scan
body once. The port's dry run runs every layer eagerly and counts each one,
so ``depth_scale`` and the reduced-depth lowerings are not ported.

``HW`` is the H100 SXM's data sheet, not a measurement: bf16 dense 989
TFLOP/s, HBM3 3.35 TB/s, NVLink 450 GB/s one way per GPU within a node of 8
GPUs, and one 400 Gb/s NIC (50 GB/s) per GPU for a group that spans nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute",
)

_KIND = {"all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_to_all_single": "all-to-all", "shard_dim_alltoall": "all-to-all"}
# the namespaces of the collectives DTensor issues: the functional ones, and
# its own all-to-all between two sharded dims (NCCL's; over gloo DTensor
# gathers instead)
COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")


def collective_alias(func) -> bool:
    """True for the functional collectives' wrap and wait: on a device their
    output is their input's buffer (on the meta device a new one)."""
    return (getattr(func, "namespace", "") == "_c10d_functional"
            and func.overloadpacket.__name__ in ("_wrap_tensor_autograd", "wait_tensor"))


def collective_kind(func) -> str | None:
    """The reference's kind of a collective op, None for any other op."""
    if getattr(func, "namespace", "") not in COLLECTIVE_NAMESPACES:
        return None
    return _KIND.get(func.overloadpacket.__name__)

HW = {  # H100 SXM, data sheet
    "peak_flops_bf16": 989e12,  # dense, per GPU
    "hbm_bw": 3.35e12,  # B/s per GPU
    "nvlink_bw": 450e9,  # B/s one way per GPU, a group within one node
    "node_gpus": 8,  # GPUs a node (NVLink domain)
    "net_bw": 50e9,  # B/s per GPU (one 400 Gb/s NIC), a group across nodes
}


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]
    seconds: float = 0.0  # operand bytes over each group's link rate (HW)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def as_dict(self):
        return {"bytes_by_kind": dict(self.bytes_by_kind),
                "count_by_kind": dict(self.count_by_kind), "total_bytes": self.total_bytes}


def shadow_op(out) -> bool:
    """True for an op DTensor runs on fake tensors of the global shapes to
    learn an output's shape (its sharding propagation): no device runs it,
    so the dry run's modes count nothing of it."""
    from torch._subclasses.fake_tensor import FakeTensor

    if torch._C._meta_in_tls_dispatch_include():
        return True
    return any(isinstance(t, FakeTensor) for t in tree_leaves(out))


def link_bw(group_size: int) -> float:
    """The link rate a collective over `group_size` ranks runs at: NVLink
    within a node, the network across nodes."""
    return HW["nvlink_bw"] if group_size <= HW["node_gpus"] else HW["net_bw"]


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective DTensor issues under it:
    ``events`` holds (kind, mesh dim name or None, group size, operand
    bytes per device). DTensor-level calls are handed on (NotImplemented),
    so what is seen is what DTensor sends. `mesh` names the groups."""

    def __init__(self, mesh=None):
        super().__init__()
        self.events: list[tuple] = []
        self._dims = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names or range(mesh.ndim)):
                self._dims[mesh.get_group(i).group_name] = (name, mesh.size(i))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if shadow_op(out):
            return out
        kind = collective_kind(func)
        if kind is not None:
            # the group's name is the call's last string (a reduce op's comes before it)
            group = [a for a in list(args) + list(kwargs.values()) if isinstance(a, str)][-1]
            dim, size = self._dims.get(group, (None, 0))
            if not size and group is not None:
                size = torch.distributed.distributed_c10d._resolve_process_group(group).size()
            nbytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(args[0]) if isinstance(t, torch.Tensor))
            self.events.append((kind, dim, int(size), int(nbytes)))
        return out

    def stats(self) -> CollectiveStats:
        by = {k: 0 for k in COLLECTIVE_KINDS}
        n = {k: 0 for k in COLLECTIVE_KINDS}
        secs = 0.0
        for kind, _, size, nbytes in self.events:
            by[kind] += nbytes
            n[kind] += 1
            secs += nbytes / link_bw(size)
        return CollectiveStats(by, n, secs)


def collective_stats(recorder: CollectiveRecorder) -> CollectiveStats:
    """Per-device operand bytes and counts of every collective recorded."""
    return recorder.stats()


@dataclasses.dataclass
class CellCosts:
    """Per-device costs of one (arch × shape × mesh) cell."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    collective_by_kind: Dict[str, float]
    collective_s: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


def measure(flops: float, hbm_bytes: float, recorder: CollectiveRecorder) -> CellCosts:
    """The cell's per-device costs: FLOPs and HBM bytes counted on the local
    shards, the collectives as recorded."""
    coll = recorder.stats()
    return CellCosts(flops=float(flops), hbm_bytes=float(hbm_bytes),
                     collective_bytes=float(coll.total_bytes),
                     collective_by_kind={k: float(v) for k, v in coll.bytes_by_kind.items()},
                     collective_s=coll.seconds)


def roofline_terms(costs: CellCosts) -> dict:
    compute_s = costs.flops / HW["peak_flops_bf16"]
    memory_s = costs.hbm_bytes / HW["hbm_bw"]
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": costs.collective_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    total = sum(terms.values())
    return {**terms, "dominant": dominant,
            "roofline_fraction": (bound_s / total) if total > 0 else 0.0,
            "step_time_lower_bound_s": bound_s}
