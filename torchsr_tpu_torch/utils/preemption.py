"""Preemption-safe training: SIGTERM -> checkpoint -> clean exit.

The port's own copy of ``torchsr_tpu/utils/preemption.py``.  Schedulers
(Slurm, Kubernetes) preempt a job with SIGTERM and a short grace period.
``PreemptionGuard`` installs a handler that only sets a flag; the
trainer polls it between host calls of its epoch loop (on CUDA, between
graph replays), and when it is set writes the full ``-latest``
checkpoint, waits for the write, and raises ``TrainingPreempted``,
which ``GANTrainer.train`` catches, so the CLI exits 0 inside the grace
period.  A resume re-runs the interrupted epoch from its start (the
reference's resume-at-epoch rule), so some of its updates apply twice.

Signal handlers can only be installed from the main thread; elsewhere
(a library caller's worker thread) the guard is inert: training runs,
and a signal takes its default action.
"""

from __future__ import annotations

import signal
from typing import Iterable


class TrainingPreempted(Exception):
    """Raised at a step boundary after the preemption save completed."""


class PreemptionGuard:
    """Latches termination signals into a flag that ``requested``
    reads::

        guard = PreemptionGuard().install()
        try:
            ...  # poll guard.requested between steps
        finally:
            guard.uninstall()
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._previous: dict = {}
        self._requested = False

    def install(self) -> "PreemptionGuard":
        try:
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self._latch)
        except ValueError:
            # not the main thread: run inert, restoring what was swapped
            self.uninstall()
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _latch(self, signum, frame) -> None:
        self._requested = True

    @property
    def active(self) -> bool:
        """Whether the handlers are installed."""
        return bool(self._previous)

    @property
    def requested(self) -> bool:
        """Whether a watched signal has been received."""
        return self._requested
