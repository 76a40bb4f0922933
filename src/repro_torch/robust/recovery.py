"""Escalating recovery policy: skip -> rollback -> hard failure (port of
repro/robust/recovery.py, pure host bookkeeping).

The guard makes a single poisoned step a no-op. K CONSECUTIVE skips mean
the state itself is bad, and the launcher escalates: it restores the newest
VALID checkpoint (checkpoint/manager.py walks past corrupt ones), optionally
decays the LR, and tries again. A fault that survives `max_rollbacks`
restores is structural: the run raises TrainingFailure for the scheduler
instead of looping. launch/train.py owns the restore itself.
"""
from __future__ import annotations

import time


class TrainingFailure(RuntimeError):
    """The rollback budget is spent: the run needs a human or a scheduler."""


class RecoveryController:
    def __init__(self, max_skips: int = 3, max_rollbacks: int = 2, backoff: float = 0.0):
        self.max_skips = max(1, int(max_skips))
        self.max_rollbacks = int(max_rollbacks)
        self.backoff = float(backoff)
        self.consecutive = 0
        self.rollbacks = 0

    def observe_step(self, ok: bool) -> bool:
        """Record one guarded step's verdict; True means 'roll back now'."""
        if ok:
            self.consecutive = 0
            return False
        self.consecutive += 1
        return self.consecutive >= self.max_skips

    def start_rollback(self) -> int:
        """Consume one retry (sleeping the linear backoff) and return the
        rollback ordinal, or raise TrainingFailure when over budget."""
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            raise TrainingFailure(
                f"training failed: {self.consecutive} consecutive anomalous "
                f"steps persisted through {self.max_rollbacks} rollbacks")
        self.consecutive = 0
        if self.backoff > 0:
            time.sleep(self.backoff * self.rollbacks)
        return self.rollbacks
