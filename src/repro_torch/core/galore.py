"""GaLore: gradient low-rank projection as a gradient transform (port of
repro/core/galore.py: ``galore`` with the in-step refresh or an external
one, over Adam — ``_managed_adam_update`` with its fp32 and int8-moment
branches and its weight apply — or over any other inner transform by the
composable path; ``make_fused_apply``, the external and pending refresh
entry points ``refresh_projectors``, ``init_pending_state``,
``refresh_projectors_pending`` and ``swap_pending_state``, the analytic
``galore_state_bytes`` and ``galore_zero_state_bytes``, ``pre_projected``
gradients and the GaLore-ZeRO state).

    R_t  = P_tᵀ G_t  (left, m ≤ n)  or  G_t P_t  (right)
    N_t  = inner(R_t)                statistics live in r × n (or m × r)
    G̃_t = α P_t N_t  or  α N_t P_tᵀ

P_t is refreshed from the current gradient when its leaf is due (galore
steps 0, T, 2T, … by default; staggered or adaptive per leaf, and each leaf
at its own rank, as core/subspace.py plans it) by ``GaLoreConfig.projector``
(an SVD, or the randomized / Newton–Schulz range finder; core/projector.py),
validated under ``guard_refresh``. With ``external_refresh`` the update
never refreshes: the launcher calls ``refresh_projectors`` before the step,
or runs the async double buffer (``refresh_projectors_pending`` on a stale
gradient, ``swap_pending_state`` at the next step boundary), whose pending
buffer lives beside the optimizer state, never inside it. Non-matrix leaves
and excluded paths (embeddings) get the same Adam math at full shape. With
``fused=True`` each GaLore leaf goes through kernels/ops.py, and every step
form (fp32 or int8 moments, emit or apply) is routed as the reference routes
it: one fused kernel launch where P fits the reference's VMEM budget
(``fits_vmem``), and where it does not (at llama_7b width r ≥ 512) the
reference's fallback — the tiled projection kernels around a plain Adam
update for the fp32 emit step, the plain step for the int8 and apply forms;
with ``fused=False`` it runs the composable project → Adam → back-project
sequence in plain torch (kernels/ref.py), the numerics oracle. Any other
inner transform (Adafactor, SGD's momentum ``trace``: ``inner=``) takes the
reference's composable path: R in f32, ``inner.update`` in the compact space
(its state built by ``inner.init`` on the projected structure: f32 zeros of
r_shape for a GaLore leaf, the parameter itself for a passthrough leaf), and
G̃ = α·P N in f32; projectors stored bf16 or int4 are dequantized on read.
No kernel lies on that path (the reference's has no Pallas call).
``make_fused_apply`` is the W-in-place form of the fused path: each GaLore
leaf's kernel also applies W ← W + η(G̃ + wd·W), so no full-size update tree
is made.

Quantized state (``GaLoreConfig.quant``, resolved per leaf into
``SubspacePlan.moments`` / ``.proj_store``): an int8 leaf stores each moment
as a ``{"q": codes, "scale": absmax}`` dict in the axis-blocked layout the
fused kernel consumes (blocks along its swept axis), and every path runs
dequant → Adam → requant on it — in the kernel when fused, in plain torch
otherwise and for passthrough leaves. Projectors are stored fp32, bf16 or
packed int4 and dequantized on read, except that the fused kernels (fp32 and
int8 moments alike) take the packed int4 P as it is.

``pre_projected`` (GaLore-DP, distributed/step.py): the GaLore leaves'
gradients arrive as the compact R already, so the update skips the
projection (and the refresh, which the launcher runs); the fused kernels and
quantized moments take full-shape gradients and refuse it, as the
reference's do.

GaLore-ZeRO (``GaLoreConfig.zero``, Adam-shaped state only): rank k of the
world holds block k of the rank dim of each GaLore leaf's moments and
projector (and of dim -2 of the passthrough moments; the layout is
distributed/state_sharding.py's). A GaLore leaf's step runs its routed
kernel on the owner's block — P[:, s], M_s, V_s, routed by ``fits_vmem`` at
the leaf's full rank — which gives the partial G̃_s = α·P_s·N̂_s; the
all-reduce sum of the partials is G̃ (the reference's "that psum IS the
weight-delta all-gather"), so the update equals the unsharded one up to the
f32 summation order. A passthrough leaf's owner updates its rows and an
all-gather puts them together. The refresh, the swap and checkpoints see the
full layout: the projectors (and, to rotate them, the moments) are gathered
first and cut into blocks again after. The W-in-place forms run the emit
kernel on the block, the sum, then the same weight update.

State layout (the reference's):
    {"step": int, "key": uint32[2] CPU tensor (the reference's
     PRNGKey(seed), passed through untouched; it seeds the randomized
     projector's sketch with the step), "proj": tree of P (scalar
     placeholders on non-galore leaves),
     "inner": {"m": tree, "v": tree, "count": int32 tensor} (Adam), or the
     inner transform's own state}
plus, only under ``adaptive_t``, "schedule": per-leaf {period, next (host
ints), overlap (0-d f32)} (core/subspace.py), checkpointed with the rest.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import GaLoreConfig
from repro_torch.core.projector import init_projector_state, prng_key, read_projector
from repro_torch.core.subspace import (
    DEFAULT_EXCLUDE,
    SubspaceManager,
    _lead,
    constrain_zero_moment,
    moment_quant_axis,
    plan_rank_axis,
    proj_shape,
    r_shape,
)
from repro_torch.distributed import world
from repro_torch.distributed.state_sharding import ZeroLayout
from repro_torch.kernels import ops, ref
from repro_torch.optim.transform import GradientTransformation, _device_of
from repro_torch.quant import codec
from repro_torch.utils import (
    flatten_up_to,
    is_dtensor,
    logical_constraint,
    tree_leaves,
    tree_leaves_with_path,
    tree_map,
    tree_unflatten_like,
)

MESH_ITEM = "ROADMAP A.13"  # what the port does not run on a mesh yet


def _project(g, P, plan):
    """R = PᵀG (left) or GP (right) in f32, placed by its logical axes (the
    rank dim on the mesh axis the kept dim does not take)."""
    if plan.side == "left":
        R = ref.galore_project(P, g)
        return logical_constraint(R, *_lead(R, plan_rank_axis(plan, plan.ax_n), plan.ax_n))
    R = ref.galore_project_right(P, g)
    return logical_constraint(R, *_lead(R, plan.ax_m, plan_rank_axis(plan, plan.ax_m)))


def _project_back(N, P, plan, alpha: float):
    """G̃ = αPN (left) or αNPᵀ (right), placed as the weight is."""
    back = ref.galore_project_back if plan.side == "left" else ref.galore_project_back_right
    return _constrain_leaf(back(P, N, alpha), plan)


def _constrain_leaf(x, plan):
    """`x` placed as its weight is (a leaf with no labels as it is)."""
    if plan.ax_m is None and plan.ax_n is None:
        return x
    return logical_constraint(x, *_lead(x, plan.ax_m, plan.ax_n))


def _constrain_moment(x, plan):
    """A compact moment placed as R is (ZeRO's ownership axes under ZeRO)."""
    if plan.zero:
        return constrain_zero_moment(x, plan)
    if plan.side == "left":
        return logical_constraint(x, *_lead(x, plan_rank_axis(plan, plan.ax_n), plan.ax_n))
    return logical_constraint(x, *_lead(x, plan.ax_m, plan_rank_axis(plan, plan.ax_m)))


def _on_local(path: str, fn, *args, **kw):
    """fn (a hand kernel's dispatcher) on the local tensors of DTensor
    arguments over a mesh of one rank, its outputs back as DTensors (an
    input updated in place comes back as its DTensor). Over a mesh of more
    ranks the kernels have no sharded form yet: that raises."""
    from torch.distributed.tensor import DTensor

    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args, **kw)
    mesh = dts[0].device_mesh
    if mesh.size() > 1:
        raise NotImplementedError(f"{path}: the fused GaLore kernels run on whole leaves; over "
                                  f"a mesh of {mesh.size()} ranks they have no sharded form "
                                  f"yet ({MESH_ITEM}): use galore_fused_adam=False")
    local = {id(a.to_local()): a for a in dts}
    out = fn(*[a.to_local() if is_dtensor(a) else a for a in args], **kw)
    placements = args[1].placements  # G's (every dispatcher takes P, G first)
    return tuple(local[id(o)] if id(o) in local
                 else DTensor.from_local(o, mesh, placements, run_check=False)
                 for o in out)


def galore(cfg: GaLoreConfig, *, inner: GradientTransformation | None = None,
           b1: float | None = None, b2: float | None = None, eps: float | None = None,
           fused: bool = False, exclude=DEFAULT_EXCLUDE, seed: int = 0,
           external_refresh: bool = False, pre_projected: bool = False,
           param_axes=None) -> GradientTransformation:
    """GaLore as a GradientTransformation. Without `inner` it is GaLore-Adam:
    b1/b2/eps are Adam's and are required, the transform owns the Adam math
    on every leaf (as the reference's managed path does), and its state has
    scale_by_adam's {m, v, count} layout. With `inner` (a statistics
    transform that is not Adam-shaped: Adafactor, SGD's trace) it runs the
    reference's composable path around it, which neither the fused kernels
    nor quantized moments serve. `seed` makes the state's key
    (TrainConfig.seed, threaded by optim/factory.py). `external_refresh`
    takes the refresh out of the update: the launcher refreshes the
    projectors itself (``refresh_projectors``, or the async pending
    buffer). `pre_projected`: the GaLore leaves' gradients are the compact
    R (GaLore-DP), which implies the external refresh. `param_axes`
    (models/model.py::param_axes) labels the leaves for tp_aware_side.
    Under cfg.zero with an inner transform the state stays whole on every
    rank: ZeRO owns Adam-shaped moments only."""
    if fused and pre_projected:
        raise ValueError("fused_adam is incompatible with pre_projected gradients")
    if cfg.quant.quantizes_moments and pre_projected:
        raise ValueError("quantized moments are incompatible with pre_projected gradients")
    if inner is not None and cfg.zero:
        cfg = dataclasses.replace(cfg, zero=0)
    if inner is not None:
        if fused:
            raise ValueError("the fused GaLore kernels run Adam: an inner transform takes the "
                             "composable path (fused=False)")
        if cfg.quant.quantizes_moments:
            raise ValueError("quantized moments require an Adam-shaped inner optimizer "
                             "(galore manages the Adam math itself)")
    elif None in (b1, b2, eps):
        if cfg.quant.quantizes_moments:
            raise ValueError(
                "quantized moments (QuantPolicy.moments='int8') bypass the inner "
                "transform — explicit b1/b2/eps matching an Adam inner are required")
        if fused:
            raise ValueError("fused_adam=True requires explicit b1/b2/eps matching the inner Adam")
        raise ValueError("galore owns the Adam math: explicit b1/b2/eps are required")
    mgr = SubspaceManager(cfg, exclude, param_axes)
    external_refresh = external_refresh or pre_projected

    def init(params):
        plans = mgr.plans(params)

        def proj_init(p, plan):
            if not plan.galore:  # a scalar placeholder keeps the tree aligned with params
                return torch.zeros((), dtype=torch.float32, device=p.device)
            return init_projector_state(proj_shape(p, plan), plan.proj_store, p.device)

        if inner is None:
            inner_state = _managed_adam_init(params, plans)
        else:
            inner_state = inner.init(tree_map(_inner_struct, params, plans))
        state = {"step": 0, "key": prng_key(seed), "proj": tree_map(proj_init, params, plans),
                 "inner": inner_state}
        sched = mgr.init_schedule(params, plans)
        if sched is not None:
            state["schedule"] = sched
        if cfg.zero:
            state = ZeroLayout(params, cfg, exclude, param_axes).shard(state)
        return state

    def update(grads, state, params=None):
        ref_tree = params if pre_projected else grads  # the full weight shapes
        plans = mgr.plans(ref_tree)
        layout = ZeroLayout(ref_tree, cfg, exclude, param_axes) if cfg.zero else None
        proj, sched = _maybe_refresh(mgr, grads, state, plans, external_refresh, layout)
        # the fused dispatch keeps packed int4 projectors packed: the fused
        # kernel unpacks them, so no f32 projector tree is made (the composite
        # route dequantizes each leaf's P on its own)
        proj_eff = _read_proj_tree(ref_tree, proj, plans, keep_packed=fused, layout=layout)
        if inner is None:
            updates, inner_state = _managed_adam_update(
                grads, proj_eff, state["inner"], plans, cfg, b1, b2, eps, fused=fused,
                pre_projected=pre_projected, layout=layout)
        else:
            updates, inner_state = _composable_update(inner, grads, proj_eff, state["inner"],
                                                      plans, cfg, params, pre_projected)
        return updates, _next_state(state, proj, inner_state, sched)

    return GradientTransformation(init, update)


def _inner_struct(p, plan):
    """What the inner transform's init sees for a leaf: f32 zeros of the
    compact shape for a GaLore leaf, the parameter itself otherwise."""
    if not plan.galore:
        return p
    return torch.zeros(r_shape(p, plan), dtype=torch.float32, device=p.device)


def _composable_update(inner, grads, proj_eff, inner_state, plans, cfg: GaLoreConfig, params,
                       pre_projected: bool = False):
    """The reference's composable path: R = PᵀG (or GP) in f32 on every
    GaLore leaf (given as R already when `pre_projected`), the passthrough
    leaves' gradients as they are, one ``inner.update`` over the compact
    tree, then α·P N (or α·N Pᵀ) in f32; passthrough updates keep the
    inner's dtype (apply_updates casts)."""

    def project(g, P, plan):
        if not plan.galore or pre_projected:
            return g
        return _project(g, P, plan)

    def back(u, P, plan):
        if not plan.galore:
            return u
        return _project_back(u.float(), P, plan, cfg.scale)

    lor_updates, inner_state = inner.update(tree_map(project, grads, proj_eff, plans),
                                            inner_state, params)
    updates = tree_map(back, lor_updates, proj_eff, plans)
    return updates, inner_state


def _maybe_refresh(mgr, grads, state, plans, external_refresh: bool, layout=None):
    """(proj, schedule) for this step: the in-step refresh of the leaves due
    at the state's step, or the state's own under an external refresh. Under
    ZeRO (`layout`) the refresh runs on the gathered projectors."""
    if external_refresh:
        return state["proj"], state.get("schedule")
    sched = state.get("schedule")
    if layout is None:
        return mgr.refresh_tree(grads, state["proj"], sched, plans, state["key"],
                                step=state["step"])
    if not any(mgr.due_mask(plans, sched, state["step"])):
        return state["proj"], sched
    proj, sched = mgr.refresh_tree(grads, layout.gather_proj(state["proj"]), sched, plans,
                                   state["key"], step=state["step"])
    return layout.shard_proj(proj), sched


def _next_state(state, proj, inner, sched):
    out = {"step": state["step"] + 1, "key": state["key"], "proj": proj, "inner": inner}
    if sched is not None:
        out["schedule"] = sched
    return out


def _read_proj_tree(ref_tree, proj, plans, keep_packed: bool = False, layout=None):
    """Dequant-on-read over the projector tree (no-op for fp32 storage);
    `ref_tree` (params or grads) gives each leaf's full shape, and under ZeRO
    (`layout`) P is this rank's block of its columns. With `keep_packed` an
    axis-blocked int4 qstate passes through as it is."""
    n = layout.n if layout is not None else 1
    dims = layout.dims if layout is not None else [{"proj": None}] * len(tree_leaves(plans))

    def read(p, P, plan, d):
        if not plan.galore or (keep_packed and codec.is_axis4_qstate(P)):
            return P
        shape = proj_shape(p, plan)
        if d["proj"] is not None:
            shape = shape[:-1] + (plan.rank // n,)
        return read_projector(P, shape)

    return tree_unflatten_like(ref_tree, [
        read(p, P, plan, d) for p, P, plan, d in zip(
            tree_leaves(ref_tree), flatten_up_to(ref_tree, proj), tree_leaves(plans), dims)])


def _managed_adam_init(params, plans):
    """scale_by_adam-layout state; int8 leaves hold {"q", "scale"} in the
    axis-blocked codec layout."""

    def per_leaf(p, plan, signed):
        shape = r_shape(p, plan) if plan.galore else p.shape
        zeros = torch.zeros(shape, dtype=torch.float32, device=p.device)
        if plan.moments == "int8":
            return codec.quant_axis_state(zeros, axis=moment_quant_axis(plan), signed=signed)
        return zeros

    return {
        "m": tree_map(lambda p, pl: per_leaf(p, pl, True), params, plans),
        "v": tree_map(lambda p, pl: per_leaf(p, pl, False), params, plans),
        "count": torch.zeros((), dtype=torch.int32, device=_device_of(params)),
    }


_PASSTHROUGH_BLOCK = 1 << 24  # elements a block of passthrough_apply


def _managed_adam_update(grads, proj_eff, inner_state, plans, cfg: GaLoreConfig,
                         b1: float, b2: float, eps: float, *, fused: bool, params=None,
                         eta=0.0, wd: float = 0.0, pre_projected: bool = False, layout=None):
    """One Adam step over every leaf; returns (updates, {m, v, count}).

    GaLore leaves run the side-matched fused kernel when `fused` (moments —
    or their codes and scales — updated in place), else the composable
    composition; int8 leaves run dequant → Adam → requant in either mode.
    Other leaves get the same bias-corrected Adam at full shape.

    With `params` given, the weight update is folded in: every leaf of
    `params` becomes W + η·(update + wd·W), in place (in the apply kernel for
    fused GaLore leaves; fp32 moments of full-shape leaves updated in place
    too), and the params tree is returned in place of the updates.

    `pre_projected`: a GaLore leaf's gradient is its compact R (the whole of
    it, or under ZeRO this rank's block). Under ZeRO (`layout`, no
    `params`) the moments and P are this rank's blocks: a GaLore leaf's
    partial G̃ is summed over the world, a passthrough leaf's owned rows are
    gathered; each leaf is routed by ``fits_vmem`` at its full rank."""
    apply_w = params is not None
    if apply_w and layout is not None:
        raise ValueError("the ZeRO step emits G̃; the caller applies it")
    n = layout.n if layout is not None else 1
    dims = (layout.dims if layout is not None
            else [{"moment": None, "proj": None}] * len(tree_leaves(plans)))
    count = inner_state["count"] + 1
    stochastic = cfg.quant.stochastic_round

    def dequant_mv(m_st, v_st, plan):
        ax = moment_quant_axis(plan)
        return (codec.dequant_axis_state(m_st, axis=ax, signed=True),
                codec.dequant_axis_state(v_st, axis=ax, signed=False))

    def requant_mv(m_t, v_t, plan, origin=None):
        ax = moment_quant_axis(plan)
        return (codec.quant_axis_state(m_t, axis=ax, signed=True, stochastic=stochastic,
                                       count=count, salt=codec.SR_SALT_M, origin=origin),
                codec.quant_axis_state(v_t, axis=ax, signed=False, stochastic=stochastic,
                                       count=count, salt=codec.SR_SALT_V, origin=origin))

    def block_origin(x, d):
        """Where this rank's block of a leaf's state (split along dim `d`)
        starts in the full leaf, and that dim's full length: the stochastic
        requant keys its coins on the full leaf's indices (None: whole)."""
        if d is None or n == 1:
            return None
        size = (x["q"] if isinstance(x, dict) else x).shape[d]
        return world.rank() * size, size * n

    def finish(out, p):
        """Fold η and wd into the weight, in place, when applying; else emit
        the update."""
        if not apply_w:
            return out
        return p.copy_(ref.apply_weight(p, out.float(), eta, wd))

    def passthrough_apply(g, m, v, p):
        """A full-shape leaf's Adam and weight apply, written into m, v and
        the weight a block of rows at a time: the same elementwise values,
        with temporaries of one block (the embedding is 1e9 elements)."""
        rows = max(1, _PASSTHROUGH_BLOCK // max(1, p[0].numel()))
        for r0 in range(0, p.shape[0], rows):
            sl = slice(r0, r0 + rows)
            out, m_t, v_t = ref.lowrank_adam_update(g[sl], m[sl], v[sl], count, b1, b2, eps)
            m[sl], v[sl] = m_t, v_t
            p[sl] = ref.apply_weight(p[sl], out.to(g.dtype).float(), eta, wd)
        return p, m, v

    def leaf(path, g, P, m_st, v_st, plan, p, d):
        qm = plan.moments == "int8"
        if not plan.galore and apply_w and not qm:
            return passthrough_apply(g, m_st, v_st, p)
        if not plan.galore:
            rows = d["moment"] is not None
            if rows:  # this rank's rows of dim -2
                g = world.shard_rows(g, g.ndim - 2, n=n)
            m, v = dequant_mv(m_st, v_st, plan) if qm else (m_st, v_st)
            out, m_t, v_t = ref.lowrank_adam_update(g, m, v, count, b1, b2, eps)
            if qm:
                at = block_origin(m_st, d["moment"])
                m_t, v_t = requant_mv(m_t, v_t, plan, None if at is None else (d["moment"], *at))
            out = out.to(g.dtype)
            if rows:
                out = world.all_gather(out, g.ndim - 2)
            return finish(out, p), m_t, v_t
        left = plan.side == "left"
        if pre_projected:
            R = g
            if d["moment"] is not None and R.shape[d["moment"]] == plan.rank and n > 1:
                R = world.shard_rows(R, R.ndim + d["moment"], n=n)  # a full R: this block
            N, m_t, v_t = ref.lowrank_adam_update(R, m_st, v_st, count, b1, b2, eps)
            back = ref.galore_project_back if left else ref.galore_project_back_right
            return back(P, N, cfg.scale), m_t, v_t
        hp = dict(b1=b1, b2=b2, eps=eps, alpha=cfg.scale)
        if fused and apply_w:
            hp.update(eta=eta, wd=wd)
        route = dict(route_rank=plan.rank)  # routed as the whole leaf is
        if qm:
            codes = (m_st["q"], m_st["scale"], v_st["q"], v_st["scale"])
            sr = dict(stochastic=stochastic, origin=block_origin(m_st, d["moment"]))
            if fused and apply_w:
                fn = (ops.galore_fused_adam8_apply_step if left
                      else ops.galore_fused_adam8_apply_step_right)
                upd, *codes = _on_local(path, fn, P, g.contiguous(), p, *codes, count, **sr,
                                        **route, **hp)
            elif fused:
                fn = ops.galore_fused_adam8_step if left else ops.galore_fused_adam8_step_right
                upd, *codes = _on_local(path, fn, P, g.contiguous(), *codes, count, **sr,
                                        **route, **hp)
            else:
                fn = ref.galore_fused_adam8_step if left else ref.galore_fused_adam8_step_right
                upd, *codes = fn(P, g, *codes, count, **sr, **hp)
                upd = finish(upd, p)
            mq, ms, vq, vs = codes
            return upd, {"q": mq, "scale": ms}, {"q": vq, "scale": vs}
        if fused and apply_w:
            fn = (ops.galore_fused_adam_apply_step if left
                  else ops.galore_fused_adam_apply_step_right)
            return _on_local(path, fn, P, g.contiguous(), p, m_st, v_st, count, **route, **hp)
        if fused:
            fn = ops.galore_fused_adam_step if left else ops.galore_fused_adam_step_right
            return _on_local(path, fn, P, g.contiguous(), m_st, v_st, count, **route, **hp)
        # the plain step (ref.galore_fused_adam_step[_right]'s operations), each
        # tensor placed by its logical axes on a mesh
        P = ref._p_plain(P, g.shape[-2] if left else g.shape[-1])
        N, m_t, v_t = ref.lowrank_adam_update(_project(g, P, plan), m_st, v_st, count, b1, b2,
                                              eps)
        upd = _constrain_leaf(finish(_project_back(N, P, plan, cfg.scale), p), plan)
        return upd, _constrain_moment(m_t, plan), _constrain_moment(v_t, plan)

    flat_p = flatten_up_to(grads, params) if apply_w else [None] * len(tree_leaves(grads))
    paths = [path for path, _ in tree_leaves_with_path(grads)]
    flat = [leaf(*xs) for xs in zip(paths, tree_leaves(grads), flatten_up_to(grads, proj_eff),
                                    flatten_up_to(grads, inner_state["m"]),
                                    flatten_up_to(grads, inner_state["v"]), tree_leaves(plans),
                                    flat_p, dims)]
    upd = [t[0] for t in flat]
    owned = [i for i, d in enumerate(dims) if d["proj"] is not None]
    for i, x in zip(owned, world.all_reduce_sum_many([upd[i] for i in owned])):
        upd[i] = x  # the owners' partial G̃, summed
    updates = tree_unflatten_like(grads, upd)
    new_m = tree_unflatten_like(grads, [t[1] for t in flat])
    new_v = tree_unflatten_like(grads, [t[2] for t in flat])
    return updates, {"m": new_m, "v": new_v, "count": count}


def make_fused_apply(cfg: GaLoreConfig, *, b1: float, b2: float, eps: float,
                     weight_decay: float = 0.0, exclude=DEFAULT_EXCLUDE,
                     external_refresh: bool = False, param_axes=None):
    """The W-in-place fast path: returns
        apply_step(params, grads, galore_state, eta) -> (params, galore_state')
    where every GaLore leaf runs one kernel that folds the weight update into
    the fused step, W ← W + η·(α P N̂ + wd·W), W updated in place, so the
    full-size f32 update of the emit path is never made (η is -lr of this
    step, a tensor on the device; the weight decay follows the AdamW chain's
    order clip → galore → +wd·W → ·(-lr)). Other leaves get the same math at
    full shape. The state layout and refresh are exactly `galore(...)`'s, so
    states swap freely between the two paths, and the emit path + chain
    stays the numerics oracle (`external_refresh` as ``galore``'s). Under
    ZeRO a W-in-place kernel cannot write W from one rank block: each leaf
    runs the emit kernel on its block, the partials are summed, and W takes
    the same update, W + η·(G̃ + wd·W)."""
    mgr = SubspaceManager(cfg, exclude, param_axes)

    def apply_step(params, grads, galore_state, eta):
        plans = mgr.plans(grads)
        layout = ZeroLayout(grads, cfg, exclude, param_axes) if cfg.zero else None
        proj, sched = _maybe_refresh(mgr, grads, galore_state, plans, external_refresh, layout)
        proj_eff = _read_proj_tree(grads, proj, plans, keep_packed=True, layout=layout)
        if layout is None:
            params, inner = _managed_adam_update(grads, proj_eff, galore_state["inner"], plans,
                                                 cfg, b1, b2, eps, fused=True, params=params,
                                                 eta=eta, wd=weight_decay)
        else:
            upd, inner = _managed_adam_update(grads, proj_eff, galore_state["inner"], plans, cfg,
                                              b1, b2, eps, fused=True, layout=layout)
            for p, u in zip(tree_leaves(params), tree_leaves(upd)):
                p.copy_(ref.apply_weight(p, u.float(), eta, weight_decay))
        return params, _next_state(galore_state, proj, inner, sched)

    return apply_step


def refresh_projectors(grads, galore_state, cfg: GaLoreConfig, exclude=DEFAULT_EXCLUDE,
                       step: int | None = None, param_axes=None, precomputed=None,
                       valid=None) -> dict:
    """The external refresh: the galore state with the projectors (and the
    adaptive schedule) refreshed from `grads`. step None recomputes every
    projector (the every-T force-all refresh); a step refreshes only the
    leaves due at it, so a staggered launcher calls it every step. The
    sketch is seeded from the state's key and step, as the in-step
    refresh's. The sharded refresh hands in `precomputed`, the owners' P
    summed over the world (distributed/step.py ``shard_units``, then
    ``sum_units``), and `valid`, the guard's verdict it read.
    Under ZeRO the refresh runs on the gathered projectors and cuts them
    into blocks again."""
    mgr = SubspaceManager(cfg, exclude, param_axes)
    gstep = galore_state["step"]
    plans = mgr.plans(grads)
    sched = galore_state.get("schedule")
    eff = gstep if step is None else step
    proj = galore_state["proj"]
    layout = None
    if cfg.zero and any(mgr.due_mask(plans, sched, eff, step is None)):
        layout = ZeroLayout(grads, cfg, exclude, param_axes)
        proj = layout.gather_proj(proj)
    proj, sched = mgr.refresh_tree(grads, proj, sched, plans, galore_state["key"], step=eff,
                                   force_all=step is None, key_step=gstep, valid=valid,
                                   precomputed=precomputed)
    if layout is not None:
        proj = layout.shard_proj(proj)
    out = {**galore_state, "proj": proj}
    if sched is not None:
        out["schedule"] = sched
    return out


def init_pending_state(params, cfg: GaLoreConfig, exclude=DEFAULT_EXCLUDE,
                       param_axes=None) -> dict:
    """Zero pending buffer, the structure refresh_projectors_pending returns
    (the restore target of a checkpoint taken with a refresh in flight). It
    is always the full layout, ZeRO or not."""
    mgr = SubspaceManager(cfg, exclude, param_axes)
    return mgr.init_pending(params, mgr.plans(params))


def refresh_projectors_pending(grads, galore_state, cfg: GaLoreConfig, exclude=DEFAULT_EXCLUDE,
                               step: int | None = None, param_axes=None, precomputed=None,
                               valid=None) -> dict:
    """refresh_projectors written into a pending buffer: the active state is
    untouched, the due leaves' P_next land in pending["proj"] with
    pending["flag"] marking them, and the post-refresh adaptive schedule
    rides along. Only "step", "key", "proj" and "schedule" of `galore_state`
    are read (the moments never enter the refresh). `grads` is the previous
    step's (stale) gradient in the async driver, the snapshot guard_refresh
    validates (`valid`: the verdict, where the caller has read it).
    `precomputed` as refresh_projectors'. The buffer is the full layout:
    under ZeRO the caller hands the gathered projectors in (the async driver
    gathers on its main thread, so no collective runs on the refresh
    thread)."""
    mgr = SubspaceManager(cfg, exclude, param_axes)
    gstep = galore_state["step"]
    return mgr.refresh_pending_tree(grads, galore_state["proj"], galore_state.get("schedule"),
                                    mgr.plans(grads), galore_state["key"],
                                    step=gstep if step is None else step,
                                    force_all=step is None, key_step=gstep, valid=valid,
                                    precomputed=precomputed)


def swap_pending_state(params, galore_state, pending, cfg: GaLoreConfig,
                       exclude=DEFAULT_EXCLUDE, param_axes=None) -> dict:
    """P_active ← P_next on the flagged leaves, with their schedule scalars
    and, under cfg.reproject_moments, their moments rotated into the new
    basis (SubspaceManager.swap_pending). `params` supplies leaf shapes.
    Under ZeRO the swap runs on the gathered state (the projectors, and the
    moments when they rotate) and cuts it into blocks again."""
    mgr = SubspaceManager(cfg, exclude, param_axes)
    if not cfg.zero:
        return mgr.swap_pending(galore_state, pending, mgr.plans(params), params)
    layout = ZeroLayout(params, cfg, exclude, param_axes)
    moments = cfg.reproject_moments
    full = layout.gather(galore_state, moments=moments)
    out = mgr.swap_pending(full, pending, mgr.plans(params), params)
    return layout.shard(out, moments=moments)


# bytes per element of persistent storage, scale overhead included
_PROJ_BYTES = {"fp32": 4.0, "bf16": 2.0,
               "int4": 0.5 + 4.0 / codec.QBLOCK}  # packed nibbles + absmax/128
_MOMENT_BYTES = {"fp32": 4.0,
                 "int8": 1.0 + 4.0 / codec.QBLOCK}  # codes + absmax/128


def galore_state_bytes(params, cfg: GaLoreConfig, exclude=DEFAULT_EXCLUDE) -> dict:
    """Analytic optimizer-state bytes (paper Table 1): projectors and
    moments, each leaf at its own plan's rank (rank_frac / rank_overrides)
    and in its resolved storage mode (int8 codes + per-block absmax, packed
    int4 projectors), beside fp32 Adam's 8 bytes a weight."""
    plans = SubspaceManager(cfg, exclude).plans(params)
    proj_elems = moment_elems = full_moment_elems = total_params = 0
    proj_bytes = moment_bytes = 0.0
    for p, plan in zip(tree_leaves(params), tree_leaves(plans)):
        size = math.prod(p.shape)
        total_params += size
        mom_b = _MOMENT_BYTES[plan.moments]
        if plan.galore:
            pe = math.prod(proj_shape(p, plan))
            me = math.prod(r_shape(p, plan))
            proj_elems += pe
            moment_elems += me
            proj_bytes += pe * _PROJ_BYTES[plan.proj_store]
            moment_bytes += 2 * me * mom_b
        else:
            full_moment_elems += size
            moment_bytes += 2 * size * mom_b
    fp32_adam = 8 * total_params  # m + v, fp32, no projector
    opt_bytes = proj_bytes + moment_bytes
    return {
        "projector_elems": proj_elems,
        "lowrank_moment_elems_each": moment_elems,
        "fullrank_moment_elems_each": full_moment_elems,
        "adam_state_elems": proj_elems + 2 * (moment_elems + full_moment_elems),
        "projector_bytes": proj_bytes,
        "moment_bytes": moment_bytes,
        "optimizer_state_bytes": opt_bytes,
        "fp32_adam_state_bytes": fp32_adam,
        "reduction_vs_fp32_adam": 1.0 - opt_bytes / max(fp32_adam, 1),
    }


def galore_zero_state_bytes(params, cfg: GaLoreConfig, n_dp: int,
                            exclude=DEFAULT_EXCLUDE) -> dict:
    """Analytic per-rank optimizer bytes under GaLore-ZeRO at `n_dp` ranks
    (the reference's): a GaLore leaf's compact moments and projector (codes
    and scales) divide by n_dp where n_dp divides its rank, a passthrough
    leaf's full-shape moments where n_dp divides its dim -2; the rest stays
    whole. Beside the replicated total and the ratio of the two."""
    full = galore_state_bytes(params, cfg, exclude)
    plans = SubspaceManager(cfg, exclude).plans(params)
    proj_b = mom_b = 0.0
    for p, plan in zip(tree_leaves(params), tree_leaves(plans)):
        mb = _MOMENT_BYTES[plan.moments]
        if plan.galore:
            div = n_dp if plan.rank % n_dp == 0 else 1
            mom_b += 2 * math.prod(r_shape(p, plan)) * mb / div
            proj_b += math.prod(proj_shape(p, plan)) * _PROJ_BYTES[plan.proj_store] / div
        else:
            div = n_dp if len(p.shape) >= 2 and p.shape[-2] % n_dp == 0 else 1
            mom_b += 2 * math.prod(p.shape) * mb / div
    opt = proj_b + mom_b
    return {
        "n_dp": n_dp,
        "projector_bytes_per_replica": proj_b,
        "moment_bytes_per_replica": mom_b,
        "opt_state_bytes_per_replica": opt,
        "replicated_opt_state_bytes": full["optimizer_state_bytes"],
        "zero_reduction_vs_replicated": full["optimizer_state_bytes"] / max(opt, 1.0),
    }
