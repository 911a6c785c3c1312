"""Optional step profiling: a ``torch.profiler`` trace of a window of
training steps.

The port of ``torchsr_tpu/utils/profiling.py`` ``StepProfiler``: after
the first ``START_AT_STEP`` steps (they hold the warm-up and the CUDA
graph captures) it traces ``num_steps`` steps, once a run, and writes a
Chrome trace (CPU and, on CUDA, device activity) to
``<out_dir>/trace.json``.  ``step(k)`` is called once a host call with
the number of training steps the call ran.

The JAX class falls back to a host step-cadence summary on TPU backends
(behind ``TORCHSR_FORCE_PROFILE``) because ``jax.profiler.start_trace``
hangs on some TPU runtimes.  CUDA has no such hang, so neither the
fallback nor the knob is ported.
"""

from __future__ import annotations

import os

import torch


class StepProfiler:
    """Trace a window of train steps, once per run."""

    # Skip the first steps: they include the warm-up and the captures.
    START_AT_STEP = 2

    def __init__(self, num_steps: int, out_dir: str, logger=None, *,
                 device: torch.device | str = "cpu") -> None:
        self.num_steps = num_steps or 0
        self.out_dir = out_dir or "traces"
        self.logger = logger
        self.device = torch.device(device)
        self._seen = 0
        self._started_at = 0
        self._prof = None
        self._done = self.num_steps <= 0

    @property
    def path(self) -> str:
        return os.path.join(self.out_dir, "trace.json")

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._started_at = self._seen

    def step(self, k: int = 1) -> None:
        """Call once per host call (after issuing it), with the number
        of training steps the call ran."""
        if self._done:
            return
        self._seen += k
        if self._prof is None:
            if self._seen > self.START_AT_STEP:
                self._start()
            return
        if self._seen - self._started_at >= self.num_steps:
            self.stop()

    def stop(self) -> None:
        """End the window (if one is open) and write its trace; the
        profiler is done for the run either way."""
        if self._prof is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)  # the window's work
            self._prof.stop()
            os.makedirs(self.out_dir, exist_ok=True)
            self._prof.export_chrome_trace(self.path)
            self._prof = None
            if self.logger is not None:
                self.logger.log(
                    f"Wrote {self._seen - self._started_at}-step profiler "
                    f"trace to {self.path}")
        self._done = True
