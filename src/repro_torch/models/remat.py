"""Activation checkpointing policies (port of repro/models/stacks.py::_remat_wrap
and of the ``checkpoint_name`` marks in repro/models/attention.py and
layers.py).

Each stack runs its units (a layer, an iRoPE group, a Jamba block) through
``run_unit`` under the config's ``remat``, only when there is no cache and
autograd is on (``stacks.run_units``):

  * ``"none"``: the unit as it is;
  * ``"full"``: the unit under ``torch.utils.checkpoint``: its input is kept
    and the unit recomputed in the backward;
  * ``"scores"``: every intermediate but each attention's (S, T) tensors is
    kept. ``attention.attend`` runs its core (mask → QKᵀ → softmax → the
    cast → PV) through ``scores_core``: a nested checkpoint whose inputs are
    q and k in f32 and v, the very tensors the un-checkpointed products
    would keep, so the unit keeps what ``"none"`` keeps less the mask, the
    softmax's exp, its row sums and the probabilities. The backward
    recomputes QKᵀ and the softmax; the recompute stops at PV's saved
    inputs, so PV is not run again. A unit without attention (an SSD layer)
    keeps what ``"none"`` keeps;
  * ``"names"``: only the unit's input and the reference's five named tensors
    are kept — q and k after rope (before the hd^-½ scale), v, the attention
    context (B, S, H·hd) before ``wo``, and the FFN hidden before ``down`` —
    where the reference names them: cross-attention names only its context,
    the MoE experts and the SSD layer name nothing. The unit runs under a
    checkpoint whose selective policy (``create_selective_checkpoint_contexts``)
    keeps the output of each ``name`` call, an alias made only under this
    policy, and recomputes every other op.

The marks cost nothing under the other policies: ``name`` returns its
argument, ``scores_core`` calls the core directly (no extra copy, no extra
op).

Where the reference differs (ROADMAP C.30): its ``"scores"`` is
``save_anything_except_these_names("attn_scores", "attn_probs")``, and the
values beside the named ones — exp(scores − m), the probabilities' bf16
cast — carry no name, so they are kept: its ``"scores"`` keeps exactly what
its ``"none"`` keeps. The port keeps no (S, T) tensor under ``"scores"``,
as the policy's docstring intends.

An eager recompute has no dead-code elimination: under ``"names"`` it
re-runs each unit up to its last saved tensor, the producers of the kept
values included, where XLA recomputes only what the backward reads; the
dry run (launch/dryrun.py) counts the FLOPs the port runs.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

POLICIES = ("none", "full", "scores", "names")

_state = threading.local()  # .policy: the unit's; .naming: inside a name() call


def active() -> str:
    """The policy of the unit running on this thread ("none" outside one)."""
    return getattr(_state, "policy", "none")


@contextlib.contextmanager
def _policy(policy: str):
    prev = active()
    _state.policy = policy
    try:
        yield
    finally:
        _state.policy = prev


def _keep_named(ctx, func, *args, **kwargs):
    """The "names" policy: keep the outputs of ``name``'s alias, recompute
    the rest."""
    if getattr(_state, "naming", False):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def name(x: torch.Tensor, tag: str) -> torch.Tensor:
    """x, kept by the unit's checkpoint under "names" (`tag` is the
    reference's ``checkpoint_name``); under any other policy x itself."""
    if active() != "names":
        return x
    _state.naming = True
    try:
        return torch.ops.aten.alias.default(x)
    finally:
        _state.naming = False


def scores_core(core, q, k, v):
    """core(q, k, v), the attention core from q and k to the context;
    under "scores" recomputed in the backward from q and k in f32 and v."""
    if active() != "scores":
        return core(q, k, v)
    return checkpoint(core, q.float(), k.float(), v, use_reentrant=False)


def run_unit(policy: str, fn, x, u):
    """fn(x, u), one unit of a stack, under `policy` (one of POLICIES)."""
    if policy not in POLICIES:
        raise NotImplementedError(f"remat policy {policy!r} is not one of {POLICIES}")

    def unit(x, u):
        with _policy(policy):
            return fn(x, u)

    if policy == "none":
        return fn(x, u)
    if policy == "scores":
        return unit(x, u)
    if policy == "full":
        return checkpoint(fn, x, u, use_reentrant=False)
    return checkpoint(unit, x, u, use_reentrant=False,
                      context_fn=functools.partial(create_selective_checkpoint_contexts,
                                                   _keep_named))
