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

On a 2-D (data, model) mesh (launch/mesh.py) the whole optimizer state is
placed by logical axes instead: ``optimizer_state_axes`` gives the axes tree
of the chain's state, leaf for leaf (the reference's): Adam's moments mirror
the params; 8-bit Adam's quantized payloads shard their block dim on the
FSDP axis; Adafactor's vr drops the last param dim and vc the second to
last; a GaLore P keeps its kept weight dim's axis with the rank replicated,
and the compact moments put the rank dim on the mesh axis the kept dim does
not take (``core/subspace.py::rank_axis``). int8 moments' codes shard like
the f32 moments they replace, their scales stay replicated; packed int4 P
codes shard their packed kept dim on "qblocks". distributed/step.py places
the state by it (``input_specs``, ``shard_opt_state``).
"""
from __future__ import annotations

import torch

from repro_torch.core.subspace import (
    DEFAULT_EXCLUDE,
    SubspaceManager,
    moment_quant_axis,
    r_shape,
    rank_axis,
    zero_state_axes,
)
from repro_torch.distributed import world
from repro_torch.quant.policy import MIN_QUANT_SIZE
from repro_torch.utils import flatten_up_to, is_axes, tree_leaves, tree_unflatten_like


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



# ---------------------------------------------------------------------------
# Logical axes of the optimizer state (the reference's optimizer_state_axes)
# ---------------------------------------------------------------------------

SCALAR = ()
QBLOCK_AXES = {"q": ("qblocks", None), "scale": ("qblocks",)}


def map_axes(fn, axes, *trees):
    """fn(axes leaf, *matching subtrees) over an axes tree, whose leaves are
    tuples of str / None (``is_axes``); dicts and other tuples are
    structure (Jamba's tuple of block dicts)."""
    if is_axes(axes):
        return fn(axes, *trees)
    if isinstance(axes, dict):
        return {k: map_axes(fn, axes[k], *(t[k] for t in trees)) for k in sorted(axes)}
    return type(axes)(map_axes(fn, a, *(t[i] for t in trees)) for i, a in enumerate(axes))


def _plans(p_axes, p_struct, gcfg):
    return SubspaceManager(gcfg, DEFAULT_EXCLUDE, p_axes).plans(p_struct)


def _adam_axes(p_axes):
    return {"m": p_axes, "v": p_axes, "count": SCALAR}


def _adam8bit_axes(p_axes, p_struct):
    def per_leaf(ax, p):
        if p.ndim and p.numel() >= MIN_QUANT_SIZE:
            return {"m": QBLOCK_AXES, "v": QBLOCK_AXES}
        return {"m": ax, "v": ax}

    return {"mv": map_axes(per_leaf, p_axes, p_struct), "count": SCALAR}


def _adafactor_axes(p_axes, p_struct, beta1):
    def per_leaf(ax, p):
        if p.ndim >= 2:
            return {"vr": tuple(ax[:-1]), "vc": tuple(ax[:-2]) + (ax[-1],)}
        return {"v": ax}

    out = {"v": map_axes(per_leaf, p_axes, p_struct), "count": SCALAR}
    if beta1 is not None:
        out["m"] = p_axes
    return out


def _projected_axes(p_axes, p_struct, gcfg):
    """Axes of the projected-gradient tree (what GaLore's inner optimizer
    sees): the rank dim on the complementary axis ("zero" under ZeRO)."""
    plans = _plans(p_axes, p_struct, gcfg)

    def per_leaf(ax, plan):
        if not plan.galore:
            if plan.zero and ax is not None and len(ax) >= 2:
                return tuple(ax[:-2]) + ("zero", ax[-1])
            return ax
        rax = (lambda kept: "zero") if plan.zero else rank_axis
        if plan.side == "left":  # R (..., r, n)
            return tuple(ax[:-2]) + (rax(ax[-1]), ax[-1])
        return tuple(ax[:-2]) + (ax[-2], rax(ax[-2]))  # R (..., m, r)

    return map_axes(per_leaf, p_axes, plans)


def _projected_struct(p_struct, gcfg, p_axes=None):
    """The projected-gradient tree on the meta device: f32 (…, r, n) or
    (…, m, r) for a GaLore leaf, the parameter itself otherwise."""
    plans = _plans(p_axes, p_struct, gcfg)
    return map_axes(
        lambda _, p, plan: (torch.empty(r_shape(p, plan), dtype=torch.float32, device="meta")
                            if plan.galore else p), p_axes, p_struct, plans)


def _galore_proj_axes(p_axes, p_struct, gcfg):
    plans = _plans(p_axes, p_struct, gcfg)

    def per_leaf(ax, plan):
        if not plan.galore:
            return SCALAR  # the scalar placeholder
        rk = "zero" if plan.zero else None
        if plan.proj_store == "int4":
            return {"q": tuple(ax[:-2]) + ("qblocks", rk), "scale": tuple(ax[:-2]) + (None, rk)}
        kept = ax[-2] if plan.side == "left" else ax[-1]
        return tuple(ax[:-2]) + (kept, rk)

    return map_axes(per_leaf, p_axes, plans)


def _galore_quant_inner_axes(p_axes, p_struct, gcfg):
    """The GaLore-managed Adam state ({m, v, count}) under the quant policy:
    int8 leaves' codes shard like the f32 moment, their scales replicated
    (under ZeRO the scales shard their rank dim with the codes)."""
    plans = _plans(p_axes, p_struct, gcfg)
    proj_ax = _projected_axes(p_axes, p_struct, gcfg)

    def per_leaf(ax, plan):
        if plan.moments == "int8":
            if plan.zero:
                blocked = moment_quant_axis(plan) % max(len(ax), 1)
                return {"q": ax, "scale": tuple(None if i == blocked else a
                                                for i, a in enumerate(ax))}
            return {"q": ax, "scale": tuple(None for _ in ax)}
        return ax

    mv = map_axes(per_leaf, proj_ax, plans)
    return {"m": mv, "v": mv, "count": SCALAR}


def _galore_schedule_axes(p_axes):
    """Adaptive T's per-leaf scalars {period, next, overlap}."""
    scalars = map_axes(lambda ax: SCALAR, p_axes)
    return {"period": scalars, "next": scalars, "overlap": scalars}


def galore_refresh_gather_axes(gcfg, p_axes, p_struct):
    """Axes of the gathered f32 projector tree a sharded refresh hands its
    epilogue: the kept dim on its mesh axis, the rank replicated; the
    placeholder of a non-GaLore leaf is a scalar."""
    plans = _plans(p_axes, p_struct, gcfg)

    def per_leaf(ax, plan):
        if not plan.galore:
            return SCALAR
        kept = ax[-2] if plan.side == "left" else ax[-1]
        return tuple(ax[:-2]) + (kept, None)

    return map_axes(per_leaf, p_axes, plans)


def _stats_axes(tc, p_axes, p_struct):
    if tc.optimizer in ("adam", "adamw"):
        return _adam_axes(p_axes)
    if tc.optimizer == "adam8bit":
        return _adam8bit_axes(p_axes, p_struct)
    if tc.optimizer == "adafactor":
        return _adafactor_axes(p_axes, p_struct, tc.b1)
    if tc.optimizer == "sgd":
        return p_axes
    raise ValueError(tc.optimizer)


def optimizer_state_axes(tc, p_axes, p_struct):
    """The axes tree of ``build_optimizer(tc).init(params)``'s state, leaf for
    leaf (`p_struct`: the params, meta tensors will do)."""
    from repro_torch.optim.factory import effective_galore_config

    gcfg = effective_galore_config(tc)
    if gcfg is not None:
        if gcfg.quant.quantizes_moments:  # GaLore-managed int8 moments
            inner_axes = _galore_quant_inner_axes(p_axes, p_struct, gcfg)
        else:
            inner_axes = _stats_axes(tc, _projected_axes(p_axes, p_struct, gcfg),
                                     _projected_struct(p_struct, gcfg, p_axes))
        stats_axes = {"step": SCALAR, "key": SCALAR,
                      "proj": _galore_proj_axes(p_axes, p_struct, gcfg), "inner": inner_axes}
        if gcfg.adaptive_t:
            stats_axes["schedule"] = _galore_schedule_axes(p_axes)
    else:
        stats_axes = _stats_axes(tc, p_axes, p_struct)
    parts = []
    if tc.grad_clip > 0:
        parts.append(())  # the clip's state
    parts.append(stats_axes)
    if tc.weight_decay > 0 and tc.optimizer == "adamw":
        parts.append(())  # the decayed weights' state
    parts.append({"count": SCALAR})  # the lr schedule
    return tuple(parts)
