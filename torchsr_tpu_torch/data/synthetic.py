"""Synthetic in-memory loaders for the bench and profile tools.

The port of ``torchsr_tpu/data/synthetic.py``: the TrainLoader /
EvalLoader batch contract with random uint8 crops made once in host RAM
from ``numpy.random.default_rng(seed)`` (no disk, no decode), so a bench
measures the device path.  For one set of arguments the batches are the
JAX package's byte for byte.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticTrainLoader:
    """Yields (uint8 crops, flip bits) batches of fixed content."""

    def __init__(
        self,
        batch_size: int,
        crop_size: int,
        n_batches: int = 8,
        seed: int = 0,
    ) -> None:
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.n_batches = n_batches
        rng = np.random.default_rng(seed)
        self._crops = rng.integers(
            0, 256, (n_batches, batch_size, crop_size, crop_size, 3),
            dtype=np.uint8,
        )
        self._flips = rng.random((n_batches, batch_size, 2)) < 0.5

    def __len__(self) -> int:
        return self.n_batches

    @property
    def dataset_len(self) -> int:
        return self.n_batches * self.batch_size

    def epoch(self, epoch_idx: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        del epoch_idx
        for b in range(self.n_batches):
            yield self._crops[b], self._flips[b]


class SyntheticEvalLoader:
    """Yields (uint8 crops, valid) batches of fixed content."""

    def __init__(
        self,
        batch_size: int,
        crop_size: int,
        n_batches: int = 2,
        seed: int = 1,
    ) -> None:
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.n_batches = n_batches
        rng = np.random.default_rng(seed)
        self._crops = rng.integers(
            0, 256, (n_batches, batch_size, crop_size, crop_size, 3),
            dtype=np.uint8,
        )

    def __len__(self) -> int:
        return self.n_batches

    @property
    def dataset_len(self) -> int:
        return self.n_batches * self.batch_size

    def __iter__(self) -> Iterator[tuple[np.ndarray, int]]:
        for b in range(self.n_batches):
            yield self._crops[b], self.batch_size
