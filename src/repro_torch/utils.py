"""Shared utilities: dtype mapping, device resolution, nested-dict tree helpers.

Parameter and state trees are nested dicts / tuples of tensors, walked in the
JAX flatten order (dict keys sorted) so that leaf order, and the dotted path
names ``path_str`` builds, match the reference's ``jax.tree_util`` trees.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Mapping, Sequence

import torch

Tree = Any

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int32": torch.int32,
}


def canonical_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, str):
        return _DTYPES[dtype]
    return dtype


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks for
    another one. With no device given and no GPU present this raises — there
    is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu on the command line) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def path_str(path) -> str:
    """Dotted path of a tree leaf, e.g. ``blocks.attn.wq`` (as the JAX
    package's ``repro.utils.path_str`` names it)."""
    return ".".join(str(p) for p in path)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn over the leaves of `tree` and the matching subtrees of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Tree, prefix: tuple = ()) -> list[tuple[str, Any]]:
    """[(dotted path, leaf)] in flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in tree_leaves_with_path(t, prefix + (i,))]
    return [(path_str(prefix), tree)]


def tree_map_with_path(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """fn(dotted path, leaf, *rest_leaves) over the leaves of `tree` (the
    reference's ``repro.utils.tree_map_with_path``)."""

    def walk(t, prefix, rs):
        if isinstance(t, dict):
            return {k: walk(t[k], prefix + (k,), [r[k] for r in rs]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x, prefix + (i,), [r[i] for r in rs]) for i, x in enumerate(t))
        return fn(path_str(prefix), t, *rs)

    return walk(tree, (), list(rest))


def is_axes(x) -> bool:
    """A logical-axes leaf: a tuple of str / None, e.g. ("embed", "ff"), (None,),
    () (the reference's ``is_axes``); a tuple of dicts (Jamba's blocks) is
    structure, not a leaf."""
    return isinstance(x, tuple) and all(e is None or isinstance(e, str) for e in x)


def axes_by_path(axes_tree: Tree) -> dict:
    """{dotted path: axes tuple} of a logical-axes tree (model.param_axes)."""
    out = {}

    def walk(t, prefix):
        if is_axes(t):
            out[path_str(prefix)] = t
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], prefix + (k,))
        else:
            for i, x in enumerate(t):
                walk(x, prefix + (i,))

    walk(axes_tree, ())
    return out


def tree_leaves(tree: Tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def flatten_up_to(structure: Tree, tree: Tree) -> list:
    """The subtrees of `tree` at the leaves of `structure`, in flatten order
    (JAX's ``treedef.flatten_up_to``): a state tree whose leaves may be
    ``{"q", "scale"}`` dicts lines up leaf for leaf with the gradient tree."""
    out = []
    tree_map(lambda _, sub: out.append(sub), structure, tree)
    return out


def tree_unflatten_like(tree: Tree, leaves) -> Tree:
    """A tree shaped like `tree` holding `leaves` in flatten order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def unstack(tree: Tree, n: int) -> list[Tree]:
    """Per-layer views of a tree of stacked (n, …) leaves. Each leaf is
    unbound once (one autograd node per leaf); indexing the stack per layer
    instead would make every layer's backward allocate a zero tensor the
    size of the whole stack."""
    views = tree_map(lambda a: a.unbind(0), tree)  # dicts of per-layer tuples

    def pick(v, i):
        return {k: pick(x, i) for k, x in v.items()} if isinstance(v, dict) else v[i]

    return [pick(views, i) for i in range(n)]


# ---------------------------------------------------------------------------
# Logical sharding context (the reference's ShardingRules / logical_constraint)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to mesh axis name(s) (or None: replicated)
    over a mesh: a ``DeviceMesh``, or anything whose ``shape`` maps each mesh
    dim's name to its size (the reference's mesh, ``mesh.shape``).

    A logical dim maps to a mesh axis only if the mesh axis size divides the
    dim; otherwise it falls back to replication (a single KV head cannot be
    sharded 16 ways), and a mesh axis is used at most once in a spec."""

    mesh: Any
    rules: Mapping[str, Any]  # logical name -> mesh axis | tuple | None

    @property
    def mesh_shape(self) -> dict:
        """{mesh dim name: size}, in the mesh's dim order."""
        names = getattr(self.mesh, "mesh_dim_names", None)
        if names is not None:  # a DeviceMesh
            return dict(zip(names, self.mesh.shape))
        return dict(self.mesh.shape)

    def mesh_axis_size(self, axis) -> int:
        if axis is None:
            return 1
        shape = self.mesh_shape
        if isinstance(axis, (tuple, list)):
            size = 1
            for a in axis:
                size *= shape[a]
            return size
        return shape[axis]

    def spec_for(self, logical: Sequence[str | None], shape: Sequence[int] | None = None
                 ) -> tuple:
        """The mesh axis (or tuple of axes, or None) of each dim: the
        reference's PartitionSpec entries, as a plain tuple."""
        out = []
        used: set[str] = set()
        for i, name in enumerate(logical):
            axis = self.rules.get(name) if name is not None else None
            if axis is not None:
                flat = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
                if any(a in used for a in flat):
                    axis = None  # a mesh axis may appear only once in a spec
                elif shape is not None and shape[i] % self.mesh_axis_size(axis) != 0:
                    axis = None  # not divisible -> replicate
                else:
                    used.update(flat)
            out.append(axis)
        return tuple(out)

    def placements_for(self, logical: Sequence[str | None], shape: Sequence[int]) -> tuple:
        """The DTensor placements of a spec, one a mesh dim: ``Shard(d)`` where
        tensor dim d takes that mesh dim (of more than one rank), else
        ``Replicate()``. A tensor dim
        over a tuple of mesh dims is sharded on each in turn (the first mesh
        dim outermost), as JAX lays such a dim out."""
        from torch.distributed.tensor import Replicate, Shard

        sizes = self.mesh_shape
        names = list(sizes)
        out = [Replicate()] * len(names)
        for d, axis in enumerate(self.spec_for(logical, shape)):
            for a in (axis if isinstance(axis, tuple) else (() if axis is None else (axis,))):
                if sizes[a] > 1:  # a dim of one rank holds the whole tensor: Replicate
                    out[names.index(a)] = Shard(d)
        return tuple(out)


# process-wide, not thread-local as the reference's: the autograd engine runs
# a CUDA backward, and the recompute of a checkpointed unit in it, on a thread
# of its own, where the step's constraints must hold too
_ACTIVE: list = [None]


@contextlib.contextmanager
def sharding_context(rules: ShardingRules | None):
    prev = _ACTIVE[0]
    _ACTIVE[0] = rules
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def active_rules() -> ShardingRules | None:
    return _ACTIVE[0]


@contextlib.contextmanager
def mesh_context(rules: ShardingRules | None):
    """A sharded step's context: `rules` active, and a plain tensor meeting a
    DTensor taken as replicated (rope tables, masks); nothing without
    rules."""
    if rules is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with sharding_context(rules), implicit_replication():
        yield


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def logical_constraint(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names: a
    DTensor is redistributed (differentiably) to the active rules'
    placements for it. A no-op outside a context and on a plain tensor."""
    rules = active_rules()
    if rules is None or not is_dtensor(x):
        return x
    # redistributed even where the placements already match: the autograd
    # node puts the gradient back on them too, as a constraint does in JAX
    return x.redistribute(x.device_mesh, rules.placements_for(logical, x.shape))


def place_like(x: torch.Tensor, ref, logical) -> torch.Tensor:
    """`x`, the same full tensor on every rank, as a DTensor on `ref`'s mesh
    placed by the active rules' placements for `logical` (replicated
    without rules)."""
    from torch.distributed.tensor import Replicate

    rules = active_rules()
    mesh = ref.device_mesh
    placements = (rules.placements_for(logical, x.shape) if rules is not None
                  else (Replicate(),) * mesh.ndim)
    return from_full(x, mesh, placements)


def from_full(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """A DTensor of the full tensor `x` (the same on every rank) with
    `placements`: each rank keeps its own slice, nothing is sent (on any
    device, the meta device included)."""
    from torch.distributed.tensor import DTensor, Shard

    local = x
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            size = local.shape[pl.dim] // n
            local = local.narrow(pl.dim, coord[i] * size, size)
    if local is not x:
        local = local.contiguous()
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                              shape=x.shape, stride=x.stride())
