"""GaLore-ZeRO state ownership: a rank's blocks of the optimizer state, and the
way back to the full layout (port of the ZeRO part of
repro/distributed/state_sharding.py: ``galore_refresh_gather_axes`` and the
"zero" labels of ``optimizer_state_axes``).

Under ``GaLoreConfig.zero`` rank k of a world of n owns block k of the dim
that ``core/subspace.py::zero_state_axes`` labels "zero" in each state
tensor:

  galore leaf, left  (m ≤ n)  moments (..., r, n) and their int8 scales
                              (..., r, nb): dim -2; P (..., m, r), or its
                              packed int4 codes (..., m_pad/2, r) and scales
                              (..., nb, r): dim -1
  galore leaf, right          moments (..., m, r), scales (..., nb, r): dim -1;
                              P (..., n, r): dim -1
  passthrough leaf, ≥ 2-D     full-shape moments (..., m, n) and their int8
                              scales (..., m, nb): dim -2

A dim that n does not divide stays whole on every rank (the reference's
``ShardingRules.spec_for`` replicates it). The int8 and int4 codes block
along the other dim, so every block is a bitwise slice of the full codes and
scales. ``shard_*`` take a rank's blocks out of a full state (no
collective); ``gather_*`` put the world's blocks back together (an
all-gather a leaf, every rank must call it): the layout checkpoints, the
refresh epilogue and the bridge read.

The reference's other logical labels place parameters on a TPU pod through
GSPMD (its FSDP rule "embed" → data, the tensor-parallel labels); a rank of
the port holds the whole model, so they are not ported (ROADMAP A.12).
"""
from __future__ import annotations

import torch

from repro_torch.core.subspace import DEFAULT_EXCLUDE, SubspaceManager, zero_state_axes
from repro_torch.distributed import world
from repro_torch.utils import flatten_up_to, tree_leaves, tree_unflatten_like


def block_dims(plan, shape, n: int) -> dict:
    """{"moment", "proj"}: the (negative) dim of this leaf's moments and of
    its projector that carries zero_state_axes' "zero" label, None where the
    state stays whole (no ZeRO, a 1-D leaf, or n does not divide the rank,
    or a passthrough leaf's dim -2)."""
    whole = {"moment": None, "proj": None}
    if not plan.zero:
        return whole
    labels = zero_state_axes(plan, (None,) * len(shape))
    at = {k: labels[k].index("zero") - len(labels[k]) if "zero" in labels[k] else None
          for k in whole}
    if at["moment"] is None or (plan.rank if plan.galore else shape[-2]) % n:
        return whole
    return at


def _block(x, dim, k: int, n: int):
    """Rank k's block of a tensor or {"q", "scale"} qstate along `dim`."""
    if dim is None or not isinstance(x, (torch.Tensor, dict)):
        return x
    if isinstance(x, dict):
        return {key: _block(v, dim, k, n) for key, v in x.items()}
    size = x.shape[dim] // n
    return x.narrow(dim, k * size, size).contiguous()


def _gathered(x, dim):
    """The world's blocks of `x` put back together along `dim`."""
    if dim is None or not isinstance(x, (torch.Tensor, dict)):
        return x
    if isinstance(x, dict):
        return {key: _gathered(v, dim) for key, v in x.items()}
    return world.all_gather(x, dim % x.ndim).contiguous()


class ZeroLayout:
    """The ownership map of one parameter tree's galore state: which dim of
    each leaf's state rank k of n holds a block of (``block_dims``)."""

    def __init__(self, params, gcfg, exclude=DEFAULT_EXCLUDE, param_axes=None,
                 n: int | None = None):
        self.n = world.n_dp() if n is None else n
        self.plans = tree_leaves(SubspaceManager(gcfg, exclude, param_axes).plans(params))
        self.params = params
        self.dims = [block_dims(pl, tuple(p.shape), self.n)
                     for p, pl in zip(tree_leaves(params), self.plans)]

    def _map(self, fn, tree, key):
        return tree_unflatten_like(self.params, [
            fn(x, d[key]) for x, d in zip(flatten_up_to(self.params, tree), self.dims)])

    def _map_state(self, fn, state, moments: bool = True):
        out = dict(state, proj=self._map(fn, state["proj"], "proj"))
        if moments and isinstance(state.get("inner"), dict) and "m" in state["inner"]:
            out["inner"] = dict(state["inner"], m=self._map(fn, state["inner"]["m"], "moment"),
                                v=self._map(fn, state["inner"]["v"], "moment"))
        return out

    def shard(self, state, k: int | None = None, *, moments: bool = True) -> dict:
        """Rank k's (this rank's) blocks of a full galore state: P and, with
        `moments`, Adam's {m, v}; step, key, count and schedule as they are."""
        k = world.rank() if k is None else k
        return self._map_state(lambda x, d: _block(x, d, k, self.n), state, moments)

    def gather(self, state, *, moments: bool = True) -> dict:
        """The full galore state from every rank's blocks (collective)."""
        return self._map_state(_gathered, state, moments)

    def join(self, states: list, *, moments: bool = True) -> dict:
        """The full galore state from every rank's blocks given in rank
        order, in one process (no collective): the bridge's and the tests'
        way to the reference's layout."""
        first = states[0]

        def cat(x, d, xs):
            if d is None or not isinstance(x, (torch.Tensor, dict)):
                return x
            if isinstance(x, dict):
                return {key: cat(x[key], d, [y[key] for y in xs]) for key in x}
            return torch.cat(xs, dim=d)

        def tree(get, key):
            per = [flatten_up_to(self.params, get(st)) for st in states]
            return tree_unflatten_like(self.params, [
                cat(xs[0], dd[key], xs) for xs, dd in zip(zip(*per), self.dims)])

        out = dict(first, proj=tree(lambda st: st["proj"], "proj"))
        if moments and isinstance(first.get("inner"), dict) and "m" in first["inner"]:
            out["inner"] = dict(first["inner"],
                                m=tree(lambda st: st["inner"]["m"], "moment"),
                                v=tree(lambda st: st["inner"]["v"], "moment"))
        return out

    def shard_proj(self, proj, k: int | None = None):
        k = world.rank() if k is None else k
        return self._map(lambda x, d: _block(x, d, k, self.n), proj, "proj")

    def gather_proj(self, proj):
        return self._map(_gathered, proj, "proj")


def shard_opt_state(opt_state, idx: int, layout: ZeroLayout, k: int | None = None):
    """The chain state with its galore state (at `idx`) cut to rank k's blocks."""
    return opt_state[:idx] + (layout.shard(opt_state[idx], k),) + opt_state[idx + 1:]


def gather_opt_state(opt_state, idx: int, layout: ZeroLayout):
    """The chain state with its galore state gathered to the full layout."""
    return opt_state[:idx] + (layout.gather(opt_state[idx]),) + opt_state[idx + 1:]


def state_bytes(tree) -> int:
    """Bytes of every tensor of at least one dim in a tree (a rank's own
    state, counted; the 0-d placeholders and counters are not state)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.ndim > 0)


def galore_state_tensor_bytes(galore_state) -> dict:
    """{"projector", "moment", "total"} bytes of a galore state's tensors:
    P (codes and scales) and Adam's m and v (codes and scales); the count,
    step, key and the passthrough leaves' 0-d P placeholders are not."""
    proj = state_bytes(galore_state["proj"])
    inner = galore_state["inner"]
    mom = state_bytes([inner["m"], inner["v"]]) if "m" in inner else state_bytes(inner)
    return {"projector": proj, "moment": mom, "total": proj + mom}

