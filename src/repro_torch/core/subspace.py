"""Subspace lifecycle: per-leaf GaLore plans, the refresh schedule, and the
async double buffer (port of the one-device part of repro/core/subspace.py,
with its poison-proof refresh: ``tree_all_finite``, ``projector_or_fallback``
and the ``guard_refresh`` gate).

A leaf projects iff it is at least 2-D, its path names no excluded module,
and min(m, n) > max(rank, min_dim); it projects on the left (R = PᵀG) iff
m ≤ n, else on the right (R = GP). Each plan carries the leaf's own rank
(``leaf_rank``: the first ``rank_overrides`` pattern found in its path, else
``rank_frac``·min(m, n), else ``rank``), its period T and its stagger offset
(with ``refresh_stagger``, (pos·T) // n_galore over the galore leaves in
flatten order, or in ``importance_order`` with ``stagger_by_importance``),
and its storage modes, resolved from ``GaLoreConfig.quant`` against the
leaf's full element count: ``moments`` (fp32 | int8) and ``proj_store``
(fp32 | bf16 | int4).

A leaf refreshes at galore step t iff t % T == offset % T, or t == 0
(``_leaf_due``, the one dueness predicate). Under ``adaptive_t`` the
schedule is state: per leaf ``{"period", "next", "overlap"}``, the leaf due
iff t ≥ next; at each refresh the period doubles where the new P overlaps
the old one by ≥ ``overlap_hi``, halves below ``overlap_lo``, is clipped to
``t_bounds`` and left alone on the first refresh, and next becomes the
offset at step 0 and t + period afterwards. The reference keeps these
scalars on the device and decides dueness inside its program; the port
keeps period and next as host ints (int32 in a checkpoint), so dueness is
read with no device sync, and the overlap as an f32 scalar on the device,
read only at a due step (whose SVD has synchronised already).

The async double buffer: ``refresh_pending_tree`` writes a refresh into a
pending buffer ``{"proj", "flag"[, "schedule"]}`` (flag 1 on the leaves it
recomputed, host ints) beside the optimizer state, and ``swap_pending``
installs it at a step boundary, with ``reproject_moments`` rotating the
compact moments into the new basis.

Under ``GaLoreConfig.guard_refresh`` a gradient with a non-finite element
makes the whole refresh a no-op (every projector and schedule scalar kept,
no pending flag set; each leaf retries at its next due step), an SVD that
fails — a non-finite P, or a ``torch.linalg.LinAlgError`` — falls back to
the randomized projector, and the swap rejects a non-finite or all-zero
P_next leaf by leaf. The reference decides these inside its program; the
port reads each verdict on the host, only where some leaf is due.

The data-parallel parts: ``partition_refresh`` bin-packs the SVD units due
at a step (one a (leaf, stacked element)) over the ranks, greedy on the cost
model (``leaf_unit_cost``, or the times ``calibrate_unit_costs`` measured,
``GaLoreConfig.unit_costs``), in numpy, so its assignment and loads equal the
reference's exactly; ``sharded_projector_tree`` computes this rank's units,
each with the sketch the unsharded refresh draws, and ``sum_units`` sums the
owners' P over the world (the reference's masked psum), so that
``refresh_tree(precomputed=…)`` stores what the unsharded refresh stores.
``ownership_axes`` / ``zero_state_axes`` label the dim of each state tensor
that GaLore-ZeRO splits into rank blocks (distributed/state_sharding.py
slices by them), and under ``tp_aware_side`` a weight with exactly one
tensor-parallel dim (``TP_LABELS``, read from ``models/model.py::
param_axes``) keeps the other one as P's row space.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.configs.base import GaLoreConfig
from repro_torch.core.projector import (
    compute_projector,
    init_projector_state,
    read_projector,
    sketch_generator,
    store_projector,
    subspace_overlap,
)
from repro_torch.quant import codec
from repro_torch.distributed import world
from repro_torch.utils import (
    axes_by_path,
    flatten_up_to,
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_unflatten_like,
)

DEFAULT_EXCLUDE = ("embed", "dec_pos")

# Logical weight-dim labels that the reference's mesh rules place on the
# tensor-parallel axis: the table tp_aware_side reads.
TP_LABELS = frozenset({"ff", "heads_flat", "kv_flat", "vocab"})


@dataclasses.dataclass(frozen=True)
class SubspacePlan:
    """Per-leaf subspace decision."""

    galore: bool
    side: str = "left"  # "left": R = P^T G ; "right": R = G P
    rank: int = 0  # this leaf's projection rank (0 for non-galore leaves)
    refresh_period: int = 0  # base T
    refresh_offset: int = 0  # stagger phase in [0, refresh_period)
    moments: str = "fp32"  # "fp32" | "int8": Adam M/V storage (compact or full-shape)
    proj_store: str = "fp32"  # "fp32" | "bf16" | "int4": persistent P storage
    ax_m: str | None = None  # logical label of dim -2 (None when unlabelled)
    ax_n: str | None = None  # logical label of dim -1
    zero: bool = False  # GaLore-ZeRO: the leaf's state is owned in rank blocks


def leaf_unit_cost(m: int, n: int, rank: int, method: str = "svd",
                   power_iters: int = 2) -> float:
    """Refresh cost of one (m, n) SVD unit, the reference's model: m·n·min(m, n)
    for the exact SVD, (2·power_iters + 2)·m·n·s with s = min(rank + 8, m, n)
    for the sketches. Only ratios matter to the bin packing."""
    if method == "svd":
        return float(m) * float(n) * float(min(m, n))
    s = min(rank + 8, m, n)
    return float(2 * power_iters + 2) * float(m) * float(n) * float(s)


def calibrate_unit_costs(params, cfg: GaLoreConfig, exclude=DEFAULT_EXCLUDE, param_axes=None,
                         iters: int = 2) -> tuple:
    """Measured refresh cost of each distinct (m, n, rank) shape (after the
    side swap) among the galore leaves: one projector compute on a Gaussian G
    on the params' device, after one untimed call, best of `iters`, as
    (((m, n, rank), seconds), ...) for GaLoreConfig.unit_costs."""
    mgr = SubspaceManager(cfg, exclude, param_axes)
    shapes = {}
    for p, plan in zip(tree_leaves(params), tree_leaves(mgr.plans(params))):
        if plan.galore:
            m, n = p.shape[-2], p.shape[-1]
            if plan.side == "right":
                m, n = n, m
            shapes[(int(m), int(n), int(plan.rank))] = 0.0
    device = tree_leaves(params)[0].device
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for m, n, rank in shapes:
        gen = torch.Generator().manual_seed(m * 131071 + n)
        G = torch.randn((m, n), generator=gen, dtype=torch.float32).to(device)
        run = lambda: compute_projector(G, rank, method=cfg.projector,  # noqa: E731
                                        generator=sketch_generator(), power_iters=cfg.power_iters)
        run()
        sync()
        best = float("inf")
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            run()
            sync()
            best = min(best, time.perf_counter() - t0)
        shapes[(m, n, rank)] = best
    return tuple(sorted(shapes.items()))


def zero_state_axes(plan: SubspacePlan, ax) -> dict:
    """The GaLore-ZeRO ownership labels of one leaf's state (the reference's):
    {"moment", "moment_scale", "proj", "proj_scale"} axes tuples over each
    state tensor's trailing dims, "zero" on the dim split into rank blocks —
    the rank dim of a galore leaf's moments, projector and their scales, dim
    -2 of a passthrough leaf's full-shape moments. The int8 and int4 codes
    block along the other dim, so a rank block is a bitwise slice."""
    ax = tuple(ax) if ax is not None else None
    if not plan.galore:
        mom = ax if ax is not None else ()
        if plan.zero and len(mom) >= 2:
            mom = tuple(mom[:-2]) + ("zero", mom[-1])
        scale = (tuple(mom[:-1]) + (None,)) if mom else ()
        return {"moment": mom, "moment_scale": scale, "proj": (), "proj_scale": ()}
    lead = tuple(ax[:-2]) if ax is not None else ()
    am = ax[-2] if ax is not None else None
    an = ax[-1] if ax is not None else None
    if plan.side == "left":  # moments (..., r, n); scales (..., r, nb)
        mom, mscale, kept = lead + ("zero", an), lead + ("zero", None), am
    else:  # moments (..., m, r); scales (..., nb, r)
        mom, mscale, kept = lead + (am, "zero"), lead + (None, "zero"), an
    if plan.proj_store == "int4":  # packed codes (..., kept_pad/2, r), scales (..., nb, r)
        proj, pscale = lead + ("qblocks", "zero"), lead + (None, "zero")
    else:
        proj, pscale = lead + (kept, "zero"), ()
    return {"moment": mom, "moment_scale": mscale, "proj": proj, "proj_scale": pscale}


def moment_quant_axis(plan: SubspacePlan) -> int:
    """Blocked axis of an int8 moment leaf: the fused kernel's swept axis for
    galore leaves (last on the left, second-to-last on the right), the last
    axis for full-shape passthrough leaves."""
    if not plan.galore:
        return -1
    return -1 if plan.side == "left" else -2


def proj_shape(p, plan: SubspacePlan) -> tuple:
    """Shape of the leaf's projector P (kept dim × plan.rank)."""
    m, n = p.shape[-2], p.shape[-1]
    return tuple(p.shape[:-2]) + ((m if plan.side == "left" else n), plan.rank)


def r_shape(p, plan: SubspacePlan) -> tuple:
    """Shape of the leaf's compact (projected) gradient / moments."""
    m, n = p.shape[-2], p.shape[-1]
    if plan.side == "left":
        return tuple(p.shape[:-2]) + (plan.rank, n)
    return tuple(p.shape[:-2]) + (m, plan.rank)


def importance_order_from_grads(grads) -> tuple:
    """Paths of the ≥ 2-D leaves by descending Frobenius norm (ties by path):
    the launcher measures it once from a real gradient and stamps it into
    GaLoreConfig.importance_order."""
    scored = [(float(torch.linalg.vector_norm(g.detach().float())), path)
              for path, g in tree_leaves_with_path(grads)
              if isinstance(g, torch.Tensor) and g.ndim >= 2]
    return tuple(p for _, p in sorted(scored, key=lambda t: (-t[0], t[1])))


def subspace_overlap_mean(P: torch.Tensor, P_ref: torch.Tensor) -> torch.Tensor:
    """0-d f32: mean squared principal cosine between two (possibly stacked)
    projectors' column subspaces, averaged over the leading dims."""
    return subspace_overlap(P, P_ref).mean()


def tree_all_finite(tree) -> torch.Tensor:
    """0-d bool tensor: every element of every float leaf is finite."""
    checks = [torch.isfinite(x).all() for x in tree_leaves(tree)
              if isinstance(x, torch.Tensor) and x.is_floating_point()]
    if not checks:
        return torch.tensor(True)
    return torch.stack(checks).all()


def projector_or_fallback(P_primary, G_in, rank: int, generator, power_iters: int):
    """P_primary when it is there and finite, else the randomized projector
    of G_in (an SVD that fails to converge returns NaN or raises; without
    this a single failure would poison P until the next refresh)."""
    if P_primary is not None and bool(torch.isfinite(P_primary).all()):
        return P_primary
    return compute_projector(G_in, rank, method="randomized", generator=generator,
                             power_iters=power_iters)


def compute_leaf_projector(g, plan: SubspacePlan, cfg: GaLoreConfig, key=None, step: int = 0):
    """Top-rank subspace of one leaf's gradient; right leaves project Gᵀ. The
    randomized methods (and the guarded SVD's fallback) draw their sketch
    from ``sketch_generator(key, step)``, the same for every leaf, as the
    reference folds one key for every leaf."""
    G_in = g if plan.side == "left" else g.transpose(-1, -2)
    gen = sketch_generator(key, step)
    if not (cfg.guard_refresh and cfg.projector == "svd"):
        return compute_projector(G_in, plan.rank, method=cfg.projector, generator=gen,
                                 power_iters=cfg.power_iters)
    try:
        P = compute_projector(G_in, plan.rank)
    except torch.linalg.LinAlgError:
        P = None
    return projector_or_fallback(P, G_in, plan.rank, gen, cfg.power_iters)


def sum_units(local: list) -> list:
    """The world's sum of each leaf's owned units (None stays None)."""
    held = [i for i, P in enumerate(local) if P is not None]
    out = list(local)
    for i, P in zip(held, world.all_reduce_sum_many([local[i] for i in held])):
        out[i] = P
    return out


class SubspaceManager:
    """Computes per-leaf SubspacePlans and drives the refresh lifecycle."""

    def __init__(self, cfg: GaLoreConfig, exclude=DEFAULT_EXCLUDE, param_axes=None):
        self.cfg = cfg
        self.exclude = exclude
        self.param_axes = param_axes
        self._ax_map = axes_by_path(param_axes) if param_axes is not None else {}
        # measured (m, n, rank) -> seconds; a shape not in it takes the model
        self._cost_table = {tuple(k): float(v) for k, v in cfg.unit_costs}

    # -- policy ------------------------------------------------------------

    @property
    def adaptive(self) -> bool:
        return bool(self.cfg.adaptive_t)

    def t_bounds(self) -> tuple[int, int]:
        """(t_min, t_max) of the adaptive period: the config's, else
        (max(1, T // 4), 8·T)."""
        T = self.cfg.update_freq
        return self.cfg.t_min or max(1, T // 4), self.cfg.t_max or 8 * T

    def unit_cost(self, m: int, n: int, rank: int) -> float:
        """Refresh cost of one (m, n) SVD unit: the calibrated time where
        cfg.unit_costs has the shape, else leaf_unit_cost."""
        hit = self._cost_table.get((int(m), int(n), int(rank)))
        if hit is not None:
            return hit
        return leaf_unit_cost(m, n, rank, self.cfg.projector, self.cfg.power_iters)

    def leaf_rank(self, path: str, m: int, n: int) -> int:
        """The first rank_overrides pattern that is a substring of `path`
        wins; else max(1, rank_frac·min(m, n)) when rank_frac > 0; else
        cfg.rank."""
        for pattern, r in self.cfg.rank_overrides:
            if pattern in path:
                return int(r)
        if self.cfg.rank_frac > 0:
            return max(1, int(self.cfg.rank_frac * min(m, n)))
        return self.cfg.rank

    def importance_rank(self, path: str) -> int:
        """Position of a leaf in cfg.importance_order (first match wins);
        unlisted leaves sort after every listed one."""
        for i, pat in enumerate(self.cfg.importance_order):
            if pat == path or pat in path:
                return i
        return len(self.cfg.importance_order)

    # -- plans -------------------------------------------------------------

    def plans(self, params):
        """Tree of SubspacePlan mirroring `params`. The stagger offsets depend
        only on the galore leaves' flatten order (and the static importance
        order), so init, update and the external refresh always agree."""
        cfg = self.cfg
        zero = cfg.zero > 0
        raw, paths = [], []
        for path, p in tree_leaves_with_path(params):
            paths.append(path)
            # the min_quant_size floor is held against the weight's size,
            # not the compact moment's (quant/policy.py)
            moments, proj_store = cfg.quant.resolve(path, math.prod(p.shape))
            ax = self._ax_map.get(path)
            labels = dict(ax_m=ax[-2], ax_n=ax[-1]) if ax and p.ndim >= 2 else {}
            if p.ndim < 2 or any(e in path for e in self.exclude):
                raw.append(SubspacePlan(False, moments=moments, zero=zero, **labels))
                continue
            m, n = p.shape[-2], p.shape[-1]
            rank = self.leaf_rank(path, m, n)
            if min(m, n) <= max(rank, cfg.min_dim):
                raw.append(SubspacePlan(False, moments=moments, zero=zero, **labels))
                continue
            side = "left" if m <= n else "right"
            if cfg.tp_aware_side and ax is not None:
                # exactly one dim tensor-parallel: keep the replicated one
                m_tp, n_tp = ax[-2] in TP_LABELS, ax[-1] in TP_LABELS
                if m_tp != n_tp:
                    side = "right" if m_tp else "left"
            raw.append(SubspacePlan(True, side, rank=rank, refresh_period=cfg.update_freq,
                                    moments=moments, proj_store=proj_store, zero=zero,
                                    **labels))
        galore_idx = [i for i, pl in enumerate(raw) if pl.galore]
        if cfg.refresh_stagger and galore_idx:
            order = list(range(len(galore_idx)))
            if cfg.stagger_by_importance and cfg.importance_order:
                # the most important leaf refreshes first in the window: the
                # same offsets, given to the leaves in another order
                order.sort(key=lambda j: (self.importance_rank(paths[galore_idx[j]]), j))
            for pos, j in enumerate(order):
                i = galore_idx[j]
                raw[i] = dataclasses.replace(
                    raw[i], refresh_offset=(pos * cfg.update_freq) // len(galore_idx))
        return tree_unflatten_like(params, raw)

    # -- the data-parallel refresh and state ownership -------------------------

    def leaf_due(self, plan: SubspacePlan, step) -> bool | None:
        """Static dueness of a leaf at `step`: None under adaptive T (the
        schedule decides at run time), else ``_leaf_due``."""
        if not plan.galore:
            return False
        if self.adaptive or not isinstance(step, (int, np.integer)):
            return None
        return bool(self._leaf_due(plan, 0, int(step), False, False))

    def partition_refresh(self, params, step, n_shards: int, plans=None):
        """Greedy LPT bin packing of the refresh work due at `step` over
        `n_shards` ranks (the reference's, in numpy).

        One unit a (leaf, stacked element); units ordered by importance_rank,
        then by cost descending, then leaf and element, each to the least
        loaded bin (max bin ≤ mean + max c_i). Returns (assignment, loads):
        an int32 array per leaf over its flattened lead dims ((1,) for a 2-D
        leaf) holding the owning rank, -1 for a passthrough leaf or one not
        due; and the float64 load of each rank. step None is the force-all
        refresh; under adaptive T every galore leaf is listed and dueness
        is decided at run time."""
        plans = self.plans(params) if plans is None else plans
        units, arrs = [], []
        for li, ((path, p), plan) in enumerate(zip(tree_leaves_with_path(params),
                                                   tree_leaves(plans))):
            if not plan.galore:
                arrs.append(np.full((1,), -1, np.int32))
                continue
            lead = math.prod(p.shape[:-2]) if p.ndim > 2 else 1
            arrs.append(np.full((lead,), -1, np.int32))
            if step is not None and self.leaf_due(plan, step) is False:
                continue
            m, n = p.shape[-2], p.shape[-1]
            if plan.side == "right":
                m, n = n, m
            cost = self.unit_cost(m, n, plan.rank)
            imp = self.importance_rank(path)
            units += [(imp, -cost, li, ei, cost) for ei in range(lead)]
        units.sort(key=lambda u: u[:4])
        loads = np.zeros((max(1, n_shards),), np.float64)
        for _, _, li, ei, cost in units:
            shard = int(np.argmin(loads))
            arrs[li][ei] = shard
            loads[shard] += cost
        return tree_unflatten_like(params, arrs), loads

    def ownership_axes(self, params, plans=None):
        """zero_state_axes of every leaf, a tree mirroring params: the ZeRO
        ownership map that distributed/state_sharding.py slices by."""
        plans = self.plans(params) if plans is None else plans
        return tree_unflatten_like(params, [
            zero_state_axes(plan, self._ax_map.get(path))
            for (path, _), plan in zip(tree_leaves_with_path(params), tree_leaves(plans))])

    def sharded_projector_tree(self, grads, plans, sched, key, *, step: int, assignment,
                               force_all: bool = False, key_step: int | None = None,
                               valid: bool = True) -> list:
        """This rank's SVD units, not yet summed over the world.

        For every leaf in the work list that is due, each stacked element
        owned by this rank (``assignment``, partition_refresh's) gets its
        projector from ``compute_leaf_projector`` with the sketch that the
        unsharded refresh draws for the whole leaf (one (key, step) stream
        for every leaf), the others zeros. Returns, in flatten order, the
        f32 P of each leaf in the work list, None elsewhere. ``sum_units``
        (one all-reduce a leaf) then holds every owner's P on every rank —
        the reference's masked psum — for ``refresh_tree(precomputed=…)``;
        the async refresh computes its units on a thread and sums them on
        the main thread at the swap, so that every collective of a rank runs
        in one order. `valid` False (a poisoned snapshot under
        guard_refresh) computes nothing."""
        cfg = self.cfg
        me = world.rank()
        adaptive = sched is not None
        flat_plans = tree_leaves(plans)
        nxt = (flatten_up_to(plans, sched["next"]) if adaptive else [0] * len(flat_plans))
        kstep = step if key_step is None else key_step
        out = []
        for g, plan, nx, assign in zip(tree_leaves(grads), flat_plans, nxt,
                                       flatten_up_to(plans, assignment)):
            assign = np.asarray(assign).reshape(-1)
            if not valid or not plan.galore or (assign < 0).all() or not self._leaf_due(
                    plan, nx, step, force_all, adaptive):
                out.append(None)
                continue
            lead = tuple(g.shape[:-2])
            g2 = g.reshape((-1,) + tuple(g.shape[-2:]))
            P = torch.zeros((g2.shape[0],) + proj_shape(g2[0], plan), dtype=torch.float32,
                            device=g.device)
            for i, owner in enumerate(assign.tolist()):
                if owner == me:
                    P[i] = compute_leaf_projector(g2[i], plan, cfg, key, kstep)
            out.append(P.reshape(lead + tuple(P.shape[-2:])))
        return out

    # -- schedule ------------------------------------------------------------

    def init_schedule(self, params, plans):
        """The adaptive schedule {period, next, overlap}, trees mirroring
        params (0 on non-galore leaves): period and next host ints, overlap a
        0-d f32 tensor on the leaf's device; None when adaptive_t is off, so
        the state layout stays the fixed-schedule one."""
        if not self.adaptive:
            return None
        return {"period": tree_map(lambda p, pl: pl.refresh_period if pl.galore else 0,
                                   params, plans),
                "next": tree_map(lambda p: 0, params),  # every leaf refreshes at step 0
                "overlap": tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                                          device=p.device), params)}

    def _leaf_due(self, plan: SubspacePlan, nxt: int, step: int, force_all: bool,
                  adaptive: bool) -> bool:
        """The one dueness predicate of a galore leaf at `step`."""
        if force_all:
            return True
        if adaptive:
            return step >= nxt
        T = plan.refresh_period
        return step % T == plan.refresh_offset % T or step == 0

    def due_mask(self, plans, sched, step: int, force_all: bool = False) -> list[bool]:
        """Per leaf (flatten order): a galore leaf due at `step`."""
        flat_plans = tree_leaves(plans)
        nxt = (flatten_up_to(plans, sched["next"]) if sched is not None
               else [0] * len(flat_plans))
        return [pl.galore and self._leaf_due(pl, n, step, force_all, sched is not None)
                for pl, n in zip(flat_plans, nxt)]

    def _snapshot_valid(self, grads, due) -> bool:
        """guard_refresh: the gradient snapshot is finite (read on the host,
        only where some leaf is due); always True unguarded."""
        if not (self.cfg.guard_refresh and any(due)):
            return True
        return bool(tree_all_finite(grads))

    # -- refresh -----------------------------------------------------------

    def refresh_tree(self, grads, proj, sched, plans, key=None, *, step: int,
                     force_all: bool = False, key_step: int | None = None, valid=None,
                     precomputed=None):
        """One refresh pass; returns (proj', sched').

        A galore leaf recomputes its projector from `grads` iff it is due at
        `step` (every leaf with `force_all`) and stores it in its plan's form
        (fp32, bf16 or a packed int4 qstate); every other leaf keeps its P.
        `key` (the galore state's uint32[2]) and `key_step` (default `step`)
        seed the randomized sketches. With ``quant.lazy_refresh`` an int4 leaf
        whose new codes equal the stored ones keeps its stored state (scales
        included). With ``guard_refresh`` a non-finite gradient keeps every
        projector and schedule scalar (`valid`: the verdict, when the caller
        has read it already). Under adaptive_t the refreshed leaves' schedule
        scalars follow the reference's rule (module docstring); sched is None
        otherwise and comes back None. `precomputed` (sharded_projector_tree's
        list) gives a due leaf its P_new in place of its own SVD, so the
        store and schedule that follow are this function's alone."""
        cfg = self.cfg
        adaptive = sched is not None
        flat_plans = tree_leaves(plans)
        due = self.due_mask(plans, sched, step, force_all)
        if valid is None:
            valid = self._snapshot_valid(grads, due)
        if not valid or not any(due):
            return proj, sched
        t_min, t_max = self.t_bounds()
        # the reference compares its f32 overlap with f32 thresholds
        hi, lo = float(np.float32(cfg.overlap_hi)), float(np.float32(cfg.overlap_lo))
        kstep = step if key_step is None else key_step
        lazy = cfg.quant.lazy_refresh
        n = len(flat_plans)
        per_f = flatten_up_to(grads, sched["period"]) if adaptive else [0] * n
        nxt_f = flatten_up_to(grads, sched["next"]) if adaptive else [0] * n
        ov_f = flatten_up_to(grads, sched["overlap"]) if adaptive else [None] * n
        pre = precomputed if precomputed is not None else [None] * n

        def refresh(g, P, plan, per, nxt, ov_old, is_due, P_pre):
            if not is_due:
                return P, per, nxt, ov_old
            P_new = (P_pre if P_pre is not None
                     else compute_leaf_projector(g, plan, cfg, key, kstep))
            new = store_projector(P_new, plan.proj_store)
            if lazy and plan.proj_store == "int4" and torch.equal(new["q"], P["q"]):
                new = P  # Q-GaLore: unmoved at 4-bit resolution
            if not adaptive:
                return new, per, nxt, ov_old
            P_old = read_projector(P, proj_shape(g, plan))
            ov = subspace_overlap_mean(P_new, P_old)
            has_old = bool(P_old.abs().sum() > 0)  # no signal on the first refresh
            per2 = per
            if has_old:
                ovf = float(ov)
                per2 = per * 2 if ovf >= hi else (per // 2 if ovf < lo else per)
                per2 = min(max(per2, t_min), t_max)
            # the step-0 refresh sets the stagger phase; then the leaf runs
            # at its own period
            nxt2 = (plan.refresh_offset if step == 0 and plan.refresh_offset > 0
                    else step + per2)
            return new, per2, nxt2, (ov if has_old else torch.zeros_like(ov))

        flat = [refresh(*xs) for xs in zip(tree_leaves(grads), flatten_up_to(grads, proj),
                                           flat_plans, per_f, nxt_f, ov_f, due, pre)]
        proj_out = tree_unflatten_like(grads, [t[0] for t in flat])
        if not adaptive:
            return proj_out, None
        return proj_out, {name: tree_unflatten_like(grads, [t[i] for t in flat])
                          for i, name in ((1, "period"), (2, "next"), (3, "overlap"))}

    # -- async double-buffered refresh (P_active / P_next) -------------------

    def init_pending(self, params, plans) -> dict:
        """Zero pending buffer, the structure refresh_pending_tree returns
        (a checkpoint restore's target): {"proj": P_next storage, "flag":
        host-int flags, 0}, plus "schedule" under adaptive_t."""

        def proj_init(p, plan):
            if not plan.galore:
                return torch.zeros((), dtype=torch.float32, device=p.device)
            return init_projector_state(proj_shape(p, plan), plan.proj_store, p.device)

        pending = {"proj": tree_map(proj_init, params, plans),
                   "flag": tree_map(lambda p: 0, params)}
        sched = self.init_schedule(params, plans)
        if sched is not None:
            pending["schedule"] = sched
        return pending

    def pending_flags(self, params, plans, sched, *, step: int, force_all: bool = False,
                      valid: bool = True):
        """Per-leaf host-int dueness at `step` (the refresh's own predicate),
        0 everywhere when the guarded snapshot was invalid."""
        due = self.due_mask(plans, sched, step, force_all)
        return tree_unflatten_like(params, [int(d and valid) for d in due])

    def refresh_pending_tree(self, grads, proj, sched, plans, key=None, *, step: int,
                             force_all: bool = False, key_step: int | None = None,
                             valid=None, precomputed=None) -> dict:
        """A refresh pass written into a pending buffer instead of the active
        store: P_next on the due leaves, the active P passed through
        elsewhere, their flags, and (adaptive) the post-refresh schedule.
        One guard verdict gates both the refresh and the flags, so a
        poisoned snapshot gives an all-zero-flag buffer whose swap is a
        no-op."""
        if valid is None:
            valid = self._snapshot_valid(grads, self.due_mask(plans, sched, step, force_all))
        proj2, sched2 = self.refresh_tree(grads, proj, sched, plans, key, step=step,
                                          force_all=force_all, key_step=key_step, valid=valid,
                                          precomputed=precomputed)
        pending = {"proj": proj2, "flag": self.pending_flags(grads, plans, sched, step=step,
                                                             force_all=force_all, valid=valid)}
        if sched2 is not None:
            pending["schedule"] = sched2
        return pending

    def swap_pending(self, galore_state, pending, plans, ref_tree) -> dict:
        """P_active ← P_next on every flagged leaf (its schedule scalars with
        it); step, key and, by default, the moments stay as the synchronous
        refresh leaves them.

        Under guard_refresh a flagged leaf's P_next must be finite and not
        all zero, or that leaf keeps its P, schedule and moments and retries
        at its next due step. With cfg.reproject_moments a swapped leaf's
        compact moments, accumulated in the old basis, rotate into the new
        one: M by Q = P_newᵀP_old (Qᵀ on the right side), V by Q∘Q, which
        keeps it nonnegative; int8 moments dequantize, rotate and requantize
        (nearest rounding) along their blocked axis. `ref_tree` (params or
        grads) gives each leaf's full shape."""
        cfg = self.cfg
        flat_ref = tree_leaves(ref_tree)
        plan_flat = tree_leaves(plans)
        flags = flatten_up_to(ref_tree, pending["flag"])
        old_proj = flatten_up_to(ref_tree, galore_state["proj"])
        new_proj = flatten_up_to(ref_tree, pending["proj"])
        takes = []
        for p, plan, flag, new in zip(flat_ref, plan_flat, flags, new_proj):
            take = plan.galore and int(flag) > 0
            if take and cfg.guard_refresh:
                P_new = read_projector(new, proj_shape(p, plan))
                take = bool(torch.isfinite(P_new).all()) and bool(P_new.abs().sum() > 0)
            takes.append(take)
        out = dict(galore_state)
        out["proj"] = tree_unflatten_like(ref_tree, [n if t else o for t, n, o in
                                                     zip(takes, new_proj, old_proj)])
        if "schedule" in galore_state and "schedule" in pending:
            out["schedule"] = {
                k: tree_unflatten_like(ref_tree, [
                    n if t else o for t, n, o in zip(
                        takes, flatten_up_to(ref_tree, pending["schedule"][k]),
                        flatten_up_to(ref_tree, galore_state["schedule"][k]))])
                for k in galore_state["schedule"]}
        inner = galore_state["inner"]
        if not (cfg.reproject_moments and any(takes)):
            return out

        def rotate(mom, p, plan, take, old, new, second):
            if not take:
                return mom
            shape = proj_shape(p, plan)
            Q = read_projector(new, shape).transpose(-1, -2) @ read_projector(old, shape)
            R = Q.square() if second else Q
            quant = plan.moments == "int8"
            ax = moment_quant_axis(plan)
            x = codec.dequant_axis_state(mom, axis=ax, signed=not second) if quant else mom
            x = R @ x if plan.side == "left" else x @ R.transpose(-1, -2)
            return codec.quant_axis_state(x, axis=ax, signed=not second) if quant else x

        new_inner = dict(inner)
        for name, second in (("m", False), ("v", True)):
            new_inner[name] = tree_unflatten_like(ref_tree, [
                rotate(*xs, second) for xs in zip(flatten_up_to(ref_tree, inner[name]), flat_ref,
                                                  plan_flat, takes, old_proj, new_proj)])
        out["inner"] = new_inner
        return out
