"""Dataset discovery and the seeded 90/10 train/test split.

The port of ``torchsr_tpu/data/discovery.py``: images are listed sorted
(``utils.image_io.discover_images``) and split by a permutation drawn
from ``numpy.random.default_rng(seed)``, so one seed gives the JAX
package's split.
"""

from __future__ import annotations

import numpy as np

from torchsr_tpu_torch.utils.image_io import discover_images

__all__ = ["discover_images", "split_dataset"]


def split_dataset(
    images: list[str], test_fraction: float = 0.1, seed: int = 0,
) -> tuple[list[str], list[str]]:
    """Shuffled train/test split, deterministic in ``seed``; the test
    set holds ceil(n * fraction) images (at least one)."""
    if not images:
        raise ValueError("no supported images found in the dataset directory")
    perm = np.random.default_rng(seed).permutation(len(images))
    n_test = max(1, int(np.ceil(len(images) * test_fraction)))
    test_idx = set(perm[:n_test].tolist())
    train = [img for i, img in enumerate(images) if i not in test_idx]
    test = [img for i, img in enumerate(images) if i in test_idx]
    if not train:
        raise ValueError(
            "dataset too small: train split is empty after the 90/10 split"
        )
    return train, test
