"""Fault tolerance (port of repro/robust/): the anomaly guard, fault
injection, and the recovery policy.

  * guard.py    — the per-step anomaly guard: finiteness of the loss and of
                  the global gradient norm, and a loss-spike z-score. A
                  tripped guard makes the step a no-op (distributed/step.py).
  * faults.py   — deterministic fault injection: traced faults (NaN / Inf /
                  spiked loss, NaN gradients) fed to the guarded step, and
                  host faults on checkpoint files.
  * recovery.py — the launcher's escalation: K consecutive skips trigger a
                  rollback to the newest valid checkpoint, with a bounded
                  budget before TrainingFailure.

The poison-proof refresh lives with the refresh (core/subspace.py, under
GaLoreConfig.guard_refresh), the async swap's check of a pending buffer
included.
"""
from repro_torch.robust.faults import (  # noqa: F401
    HOST_KINDS,
    TRACED_KINDS,
    FaultInjector,
    FaultSpec,
    identity_fault,
    parse_fault,
)
from repro_torch.robust.guard import guard_step, init_guard_state  # noqa: F401
from repro_torch.robust.recovery import RecoveryController, TrainingFailure  # noqa: F401
