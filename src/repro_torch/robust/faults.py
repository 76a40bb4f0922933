"""Deterministic fault injection: the chaos harness behind the recovery tests
(port of repro/robust/faults.py).

Faults are specified as ``kind@step`` or ``kind@step*count`` (a fault that
persists `count` consecutive steps):

  TRACED faults ride inside the guarded train step as identity-default 0-d
  f32 inputs {"loss_add": 0, "grad_scale": 1} (TrainConfig.fault_hooks).
  `loss_add` perturbs the loss VALUE after the gradient is taken
  (nan_loss / inf_loss / spike_loss test the loss side of the guard with
  finite gradients); `grad_scale` poisons every gradient leaf while the loss
  stays finite (nan_grad).

  HOST faults corrupt launcher-side state between steps: the newest on-disk
  checkpoint (corrupt_ckpt truncates its npz, so validation fails and a
  rollback must walk back) and a kill mid-save (kill_save leaves a stale
  ``step_XXXXXXXX.tmp_<pid>`` directory for the manager's init to collect).
  corrupt_pending poisons an async refresh's in-flight pending buffer
  (``poison_pending``; the launcher fires it after the step's dispatch),
  which the guarded swap then rejects leaf by leaf.

Injection is deterministic and fires once per (spec, step): two runs with
the same specs see the same faults.
"""
from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch

from repro_torch.utils import tree_map

TRACED_KINDS = ("nan_loss", "inf_loss", "spike_loss", "nan_grad")
HOST_KINDS = ("corrupt_pending", "corrupt_ckpt", "kill_save")

_SPIKE = 1.0e4  # spike_loss offset: far outside any EMA band

_SPEC_RE = re.compile(r"^([a-z_]+)@(\d+)(?:\*(\d+))?$")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    kind: str
    step: int
    count: int = 1  # traced faults fire on steps [step, step + count)


def parse_fault(spec: str) -> FaultSpec:
    """'nan_loss@3' / 'spike_loss@12*4' -> FaultSpec (CLI --inject-fault)."""
    m = _SPEC_RE.match(spec.strip())
    if not m:
        raise ValueError(f"bad fault spec {spec!r}: expected kind@step or kind@step*count")
    kind, step, count = m.group(1), int(m.group(2)), int(m.group(3) or 1)
    if kind not in TRACED_KINDS + HOST_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}: traced {TRACED_KINDS}, "
                         f"host-side {HOST_KINDS}")
    return FaultSpec(kind, step, count)


def identity_fault(device=None) -> dict:
    """The no-fault input: adding 0 to the loss and scaling gradients by 1
    leave the step exactly as it was."""
    return {"loss_add": torch.zeros((), dtype=torch.float32, device=device),
            "grad_scale": torch.ones((), dtype=torch.float32, device=device)}


class FaultInjector:
    """Holds the parsed specs and answers 'what breaks at step N?'."""

    def __init__(self, specs):
        self.specs = [parse_fault(s) if isinstance(s, str) else s for s in (specs or [])]
        self._fired: set[int] = set()  # host-side specs consumed (by index)
        self._injected: set[tuple] = set()  # traced (spec index, step) consumed

    @property
    def needs_traced_hooks(self) -> bool:
        return any(s.kind in TRACED_KINDS for s in self.specs)

    def traced_fault(self, step: int, device=None) -> dict:
        """The step's fault input (the identity when nothing is due).

        Each (spec, step) fires once ever: a traced fault models transient
        corruption, so a rollback's replay of the step is clean, while a
        `*count` window keeps poisoning its next un-fired steps after each
        replay (what spends the rollback budget in the hard-failure tests)."""
        fault = identity_fault(device)
        for i, s in enumerate(self.specs):
            if s.kind not in TRACED_KINDS or not (s.step <= step < s.step + s.count):
                continue
            if (i, step) in self._injected:
                continue
            self._injected.add((i, step))
            if s.kind == "nan_loss":
                fault["loss_add"].fill_(float("nan"))
            elif s.kind == "inf_loss":
                fault["loss_add"].fill_(float("inf"))
            elif s.kind == "spike_loss":
                fault["loss_add"].fill_(_SPIKE)
            elif s.kind == "nan_grad":
                fault["grad_scale"].fill_(float("nan"))
        return fault

    def take(self, kind: str, step: int) -> bool:
        """Fire-once host-side trigger: True the first time `step` reaches a
        matching spec's step."""
        for i, s in enumerate(self.specs):
            if s.kind == kind and i not in self._fired and step >= s.step:
                self._fired.add(i)
                return True
        return False

    # -- host-side corruption ------------------------------------------------

    @staticmethod
    def poison_pending(pending: dict) -> dict:
        """NaN every float tensor of a pending projector buffer, flags kept."""
        def leaf(x):
            if isinstance(x, torch.Tensor) and x.is_floating_point() and x.ndim > 0:
                return torch.full_like(x, float("nan"))
            return x

        return {"proj": tree_map(leaf, pending["proj"]),
                **{k: v for k, v in pending.items() if k != "proj"}}

    @staticmethod
    def corrupt_latest(ckpt_root: str) -> str | None:
        """Truncate the newest committed checkpoint's npz mid-file (a torn
        write). Returns the mangled path (None if there is none)."""
        steps = sorted(int(m.group(1)) for m in
                       (re.fullmatch(r"step_(\d{8})", n) for n in os.listdir(ckpt_root)) if m)
        for s in reversed(steps):
            d = os.path.join(ckpt_root, f"step_{s:08d}")
            for name in sorted(os.listdir(d)):
                if name.endswith(".npz"):
                    path = os.path.join(d, name)
                    size = os.path.getsize(path)
                    with open(path, "r+b") as f:
                        f.truncate(max(1, size // 2))
                    return path
        return None

    @staticmethod
    def leave_stale_tmp(ckpt_root: str, step: int) -> str:
        """A kill mid-save: a partly written tmp directory with the real name
        (step_XXXXXXXX.tmp_<pid>) and no META.json, which the manager must
        ignore and collect."""
        tmp = os.path.join(ckpt_root, f"step_{step:08d}.tmp_{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "host_0.npz"), partial=np.zeros(3))
        return tmp
