"""SIGTERM preemption guard (counterpart of facialmmt_tpu/utils/preemption.py).

A machine that is about to be taken away (a preemptible or spot instance, a
scheduler's eviction) sends SIGTERM with a short grace window.  The guard
flips a flag at signal time (signal-safe: no IO in the handler); the training
loop polls it at batch boundaries, writes a resume checkpoint and raises
`Preempted`.  Calling `Trainer.run_multimodal(..., resume=True)` afterwards
continues the interrupted epoch from the mid-epoch state (parameters,
optimizer moments, schedule position, batch counters, random generator).

Nothing installs the guard by itself: a training script that wants SIGTERM
turned into a checkpoint calls `install_preemption_guard()` before the run.
"""

from __future__ import annotations

import signal
from typing import Optional


class Preempted(Exception):
    """Raised by a training loop after the preemption checkpoint is saved."""

    def __init__(self, epoch: int, path: str):
        super().__init__(f"preempted during epoch {epoch}; resume "
                         f"checkpoint at {path}")
        self.epoch = epoch
        self.path = path


class PreemptionGuard:
    """Install once per process; poll `requested` at safe points."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._prev: dict = {}
        self._requested = False
        self._installed = False

    def install(self) -> "PreemptionGuard":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self._installed = False
        self._requested = False

    def _on_signal(self, signum, frame) -> None:
        self._requested = True

    def trigger(self) -> None:
        """Programmatic preemption (tests, external schedulers)."""
        self._requested = True

    def reset(self) -> None:
        """Clear a stale request (a new run in the same process must not
        inherit the previous run's preemption)."""
        self._requested = False

    @property
    def requested(self) -> bool:
        return self._requested


_guard: Optional[PreemptionGuard] = None


def install_preemption_guard() -> PreemptionGuard:
    """Idempotent process-level install; returns the active guard with any
    stale request cleared."""
    global _guard
    if _guard is None or not _guard._installed:
        _guard = PreemptionGuard().install()
    else:
        _guard.reset()
    return _guard


def preemption_requested() -> bool:
    return _guard is not None and _guard.requested
