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
    the MoE experts and the SSD layer name nothing. The backward recomputes
    only what it reads, as XLA's rematerialisation does (ROADMAP C.31): a
    ``_Tape`` records the unit's aten ops as they run, every tensor autograd
    saves is stored as its place on the tape unless it is the unit's input,
    a parameter or a named tensor (or a view of one), and unpacking it
    replays on the tape just the ops between the kept tensors and it. For a
    dense layer that is the two norms, QKᵀ and the softmax, ``wo`` (norm2
    reads x + ctx·W_o), ``gate``, ``up`` and the SiLU (and rope's cos and
    sin, from the angles); never the q/k/v projections, the rotation or PV,
    whose outputs are kept, nor ``down``, whose output no backward reads. A value replayed for one saved tensor is held
    until the last saved tensor whose ops read it is unpacked, so no op is
    replayed twice.

The marks cost nothing under the other policies: ``name`` returns its
argument, ``scores_core`` calls the core directly (no extra copy, no extra
op).

Where the reference differs (ROADMAP C.30): its ``"scores"`` is
``save_anything_except_these_names("attn_scores", "attn_probs")``, and the
values beside the named ones — exp(scores − m), the probabilities' bf16
cast — carry no name, so they are kept: its ``"scores"`` keeps exactly what
its ``"none"`` keeps. The port keeps no (S, T) tensor under ``"scores"``,
as the policy's docstring intends.
"""
from __future__ import annotations

import contextlib
import threading
import weakref

import torch
from torch.autograd.graph import saved_tensors_hooks
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from repro_torch.utils import active_rules, mesh_context

POLICIES = ("none", "full", "scores", "names")
_aten = torch.ops.aten
# ops whose output a replay would not reproduce: their memory is whatever the
# allocator hands out, and a kernel outside the dispatcher may fill it
_UNINITIALISED = (_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
                  _aten.new_empty_strided)

_state = threading.local()  # .policy: the unit's; .tape: the "names" unit's _Tape


def active() -> str:
    """The policy of the unit running on this thread ("none" outside one)."""
    return getattr(_state, "policy", "none")


@contextlib.contextmanager
def _policy(policy: str, tape=None):
    prev = active(), getattr(_state, "tape", None)
    _state.policy, _state.tape = policy, tape
    try:
        yield
    finally:
        _state.policy, _state.tape = prev


def name(x: torch.Tensor, tag: str) -> torch.Tensor:
    """x, kept for the backward under "names" (`tag` is the reference's
    ``checkpoint_name``); under any other policy x itself."""
    if active() != "names":
        return x
    out = torch.ops.aten.alias.default(x)
    _state.tape.keep(out)
    return out


def _checkpoint(fn, *args):
    """torch's non-reentrant checkpoint of fn(*args); on a mesh its recompute
    runs in the step's mesh context, which the autograd engine's own thread
    (a CUDA backward's) does not inherit."""
    rules = active_rules()
    if rules is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), mesh_context(rules)))


def scores_core(core, q, k, v):
    """core(q, k, v), the attention core from q and k to the context;
    under "scores" recomputed in the backward from q and k in f32 and v."""
    if active() != "scores":
        return core(q, k, v)
    return _checkpoint(core, q.float(), k.float(), v)


class _Const:
    """A tensor the tape holds as it is: the unit's input, a parameter, a
    named tensor, or the output of an op that cannot be replayed."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class _Op:
    """A recorded aten op: its arguments with each tensor left out, and
    `slots` (position, index in a list or -1, node, output) saying where each
    tensor goes and whose output it is."""

    __slots__ = ("func", "args", "kwargs", "slots", "lists")

    def __init__(self, func, args, kwargs, slots, lists):
        self.func, self.args, self.kwargs, self.slots, self.lists = (func, args, kwargs, slots,
                                                                      lists)

    def call(self, values):
        args, kwargs = list(self.args), dict(self.kwargs)
        for pos in self.lists:
            where = args if type(pos) is int else kwargs
            where[pos] = list(where[pos])
        for pos, j, node, out in self.slots:
            where = args if type(pos) is int else kwargs
            if j < 0:
                where[pos] = values[node][out]
            else:
                where[pos][j] = values[node][out]
        res = self.func(*args, **kwargs)
        return list(res) if isinstance(res, (list, tuple)) else [res]


class _Saved:
    """A saved tensor stored as its place on the tape: output `out` of node
    `node`. One that dies unread (its autograd node freed, as a detached
    amax's is at once) stops holding what it would have read."""

    __slots__ = ("tape", "node", "out", "counted", "unpacked", "__weakref__")

    def __init__(self, tape, node, out):
        self.tape, self.node, self.out = tape, node, out
        self.counted = self.unpacked = False

    def __del__(self):
        if self.counted and not self.unpacked:
            self.tape._release(self.node)


def _storage(t):
    return t.untyped_storage()._cdata


_WRITES: dict = {}  # op -> None if the tape replays it, else the arguments it writes


def _writes_of(func):
    """None when `func` replays to the same values, else the (position, name)
    of each argument it writes."""
    if func not in _WRITES:
        replayable = (func.namespace == "aten" and not func._schema.is_mutable
                      and torch.Tag.nondeterministic_seeded not in func.tags
                      and func.overloadpacket not in _UNINITIALISED)
        _WRITES[func] = None if replayable else tuple(
            (i, a.name) for i, a in enumerate(func._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write)
    return _WRITES[func]


def _outputs(out):
    return out if isinstance(out, (list, tuple)) else (out,)


class _Tape(TorchDispatchMode):
    """The aten ops of one unit's forward, replayed in its backward.

    A tensor the unit's ops make has a place (node, output); any other
    tensor an op reads becomes a ``_Const`` node. Ops that cannot be
    replayed to the same values — RNG draws, uninitialised memory, other
    namespaces than aten (a collective among them), and ops that write their
    arguments — are run and their outputs held as ``_Const``s; a constant
    whose storage such an op writes is first copied, and a read through an
    older view of a written storage reads a copy taken then, so every replay
    sees what the forward saw.

    ``pack`` returns a saved tensor as it is when its storage is held anyway
    (a ``_Const``'s), else a ``_Saved`` place. ``close`` drops every node no
    living place needs and counts, for each node left, the places and the
    ops that read it; ``unpack`` replays the missing nodes under no_grad,
    keeps each value until its count falls to 0, and drops it then.
    """

    def __init__(self):
        super().__init__()
        self.nodes: list = []
        self._where: dict = {}  # id(tensor) -> (weakref, node, out, its storage's writes then)
        self._writes: dict = {}  # storage -> writes to it under the tape
        self._held: dict = {}  # storage -> [_Const node] holding a tensor of it
        self._kept: set = set()  # storages a const holds
        self._saved: list = []
        self._values: dict = {}  # node -> list of its outputs, while counted
        self._count: dict = {}

    # -- the forward -------------------------------------------------------

    def _register(self, t, k, i, st=None) -> None:
        w = self._writes.get(st if st is not None else _storage(t), 0) if self._writes else 0
        self._where[id(t)] = (weakref.ref(t), k, i, w)

    def _const(self, t) -> int:
        k = len(self.nodes)
        self.nodes.append(_Const(t))
        st = _storage(t)
        self._held.setdefault(st, []).append(k)
        self._kept.add(st)
        self._register(t, k, 0, st)
        return k

    def keep(self, t) -> None:
        """Hold `t` (a named tensor) as it is."""
        self._const(t)

    def _hit(self, t):
        e = self._where.get(id(t))
        return e if e is not None and e[0]() is t else None

    def _place(self, t):
        """(node, out) of tensor `t`, read now."""
        e = self._hit(t)
        if e is not None and (not self._writes or e[3] == self._writes.get(_storage(t), 0)):
            return e[1], e[2]
        # made outside the unit, or read through a view of a written storage
        fresh = t if e is None and not self._writes.get(_storage(t)) else t.clone()
        return self._const(fresh), 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        written = _writes_of(func)
        if written is not None:
            for i, name in written:
                arg = args[i] if i < len(args) else kwargs.get(name)
                for t in (arg if isinstance(arg, (list, tuple)) else [arg]):
                    if isinstance(t, torch.Tensor):
                        self._write(t)
            out = func(*args, **kwargs)
            for t in _outputs(out):
                if isinstance(t, torch.Tensor):
                    self._const(t)
            return out
        rec_args, rec_kwargs, slots, lists = list(args), dict(kwargs), [], []
        for where, items in ((rec_args, enumerate(args)), (rec_kwargs, kwargs.items())):
            for pos, a in items:
                if isinstance(a, torch.Tensor):
                    slots.append((pos, -1) + self._place(a))
                    where[pos] = None
                elif isinstance(a, (list, tuple)) and any(isinstance(x, torch.Tensor) for x in a):
                    lists.append(pos)
                    where[pos] = [None if isinstance(x, torch.Tensor) else x for x in a]
                    slots.extend((pos, j) + self._place(x) for j, x in enumerate(a)
                                 if isinstance(x, torch.Tensor))
        out = func(*args, **kwargs)
        k = len(self.nodes)
        self.nodes.append(_Op(func, tuple(rec_args), rec_kwargs, slots, lists))
        for i, t in enumerate(_outputs(out)):
            if isinstance(t, torch.Tensor):
                self._register(t, k, i)
        return out

    def _write(self, t) -> None:
        st = _storage(t)
        for k in self._held.get(st, ()):  # what the constants held before the write
            self.nodes[k].value = self.nodes[k].value.clone()
        self._held.pop(st, None)
        self._kept.discard(st)
        self._writes[st] = self._writes.get(st, 0) + 1

    def pack(self, t):
        if self._hit(t) is None or _storage(t) in self._kept:
            return t
        node, out = self._place(t)
        if isinstance(self.nodes[node], _Const):
            return t
        saved = _Saved(self, node, out)
        self._saved.append(weakref.ref(saved))
        return saved

    def close(self) -> None:
        """Keep only the nodes the saved places read, and count their readers."""
        self._where = self._held = self._writes = self._kept = None
        saved = [s for s in (r() for r in self._saved) if s is not None]
        need, todo = set(), [s.node for s in saved]
        while todo:
            k = todo.pop()
            if k in need:
                continue
            need.add(k)
            node = self.nodes[k]
            if isinstance(node, _Op):
                todo.extend(slot[2] for slot in node.slots)
        self.nodes = [n if k in need else None for k, n in enumerate(self.nodes)]
        count = dict.fromkeys(need, 0)
        for k in need:
            node = self.nodes[k]
            if isinstance(node, _Op):
                for slot in node.slots:
                    count[slot[2]] += 1
        for s in saved:
            count[s.node] += 1
            s.counted = True
        self._count = count
        self._saved = None

    # -- the backward ------------------------------------------------------

    def unpack(self, saved):
        if not isinstance(saved, _Saved):
            return saved
        first, saved.unpacked = not saved.unpacked, True
        with torch.no_grad():
            value = self._value(saved.node, counted=first)[saved.out]
        if first:
            self._release(saved.node)
        return value

    def _release(self, k) -> None:
        self._count[k] -= 1
        if self._count[k] == 0:
            self._values.pop(k, None)

    def _value(self, k, counted=True):
        """The outputs of node `k`, replaying what is missing (held while
        counted; an unpack after the first replays into a scratch memo)."""
        values = self._values if counted else dict(self._values)
        stack = [k]
        while stack:
            j = stack[-1]
            if j in values:
                stack.pop()
                continue
            node = self.nodes[j]
            if isinstance(node, _Const):
                values[j] = [node.value]
                stack.pop()
                continue
            missing = [slot[2] for slot in node.slots if slot[2] not in values]
            if missing:
                stack.extend(missing)
                continue
            stack.pop()
            values[j] = node.call(values)
            if counted:
                for slot in node.slots:
                    self._release(slot[2])
        return values[k]


def run_unit(policy: str, fn, x, u):
    """fn(x, u), one unit of a stack, under `policy` (one of POLICIES)."""
    if policy not in POLICIES:
        raise NotImplementedError(f"remat policy {policy!r} is not one of {POLICIES}")
    if policy == "none":
        return fn(x, u)
    if policy == "scores":
        with _policy(policy):
            return fn(x, u)
    if policy == "full":
        return _checkpoint(fn, x, u)
    tape = _Tape()
    with saved_tensors_hooks(tape.pack, tape.unpack), _policy(policy, tape), tape:
        out = fn(x, u)
    tape.close()
    return out
