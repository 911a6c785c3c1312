"""Training logs: printed lines, a JSONL metrics file, optional WandB.

The port of ``torchsr_tpu/utils/logging.py``, with the reference's
metric keys (``psnr/train-loss``, ``{psnr|gan}/PSNR``, ``../SSIM``,
``../val-loss``, ``../throughput/{train,test}``, ``gan/{gen,disc}-lr``,
...).  ``--metrics-file`` appends one JSON dict per call with its
``step``.  WandB is used only where the package is installed; it is
imported when the logger is made, never required.
"""

from __future__ import annotations

import json


class Logger:
    """Print + JSONL (+ WandB where installed) metric logging; on a
    data-parallel run's other ranks (``main_process`` False) it prints
    and writes nothing."""

    def __init__(self, config=None, metrics_path: str | None = None,
                 main_process: bool = True) -> None:
        self.main_process = main_process
        wandb = None
        if main_process:
            try:
                import wandb
            except ImportError:
                wandb = None
        self._wandb = wandb
        self._metrics_fh = None
        if wandb is not None:
            wandb.init(config=config, name="TorchSR", project="torchsr")
        if metrics_path and main_process:
            self._metrics_fh = open(metrics_path, "a", buffering=1)
            if config is not None:
                self._metrics_fh.write(json.dumps({"config": {
                    k: v for k, v in dict(config).items()
                    if isinstance(v, (int, float, str, bool, type(None)))
                }}) + "\n")

    @property
    def active(self) -> bool:
        """True when per-step values are consumed (a sink is open), so
        hot loops skip the device sync of reading them otherwise."""
        return self._wandb is not None or self._metrics_fh is not None

    @property
    def logs_images(self) -> bool:
        return self._wandb is not None

    def log(self, statement: str) -> None:
        if self.main_process:
            print(statement, flush=True)

    def log_metrics(self, contents: dict, step: int | None = None) -> None:
        if self._wandb is not None:
            self._wandb.log(contents, step=step)
        if self._metrics_fh is not None:
            self._metrics_fh.write(
                json.dumps({"step": step, **contents}) + "\n")

    def log_image(self, key: str, image) -> None:
        if self._wandb is not None:
            self._wandb.log({key: self._wandb.Image(image)})

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._metrics_fh is not None:
            self._metrics_fh.close()
            self._metrics_fh = None
