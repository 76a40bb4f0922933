"""Shared utilities: dtype mapping, device resolution, nested-dict tree helpers.

Parameter and state trees are nested dicts / tuples of tensors, walked in the
JAX flatten order (dict keys sorted) so that leaf order, and the dotted path
names ``path_str`` builds, match the reference's ``jax.tree_util`` trees.
"""
from __future__ import annotations

from typing import Any, Callable

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
