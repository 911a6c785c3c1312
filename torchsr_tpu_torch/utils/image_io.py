"""Image file I/O: decode to uint8 arrays, save float images as files.

Pillow is imported where an image is read or written, so the package
imports without it.
"""

from __future__ import annotations

import os

import numpy as np

from torchsr_tpu_torch.constants import SUPPORTED_IMAGES


def load_image(path: str) -> np.ndarray:
    """Decode an image to an HxWx3 uint8 RGB array."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def to_uint8(image: np.ndarray) -> np.ndarray:
    """Float [0,1] HWC/NHWC -> uint8, with torchvision save_image rounding
    (mul 255, round-half-away, clamp)."""
    arr = np.asarray(image, dtype=np.float32)
    return np.clip(np.floor(arr * 255.0 + 0.5), 0, 255).astype(np.uint8)


def save_image(image: np.ndarray, path: str) -> None:
    """Save a float [0,1] HWC (or 1HWC) array as a PNG/JPEG file."""
    from PIL import Image

    arr = np.asarray(image)
    if arr.ndim == 4:
        if arr.shape[0] != 1:
            raise ValueError("save_image expects a single image")
        arr = arr[0]
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    Image.fromarray(to_uint8(arr)).save(path)


def discover_images(directory: str) -> list[str]:
    """Supported images (.jpg/.jpeg/.png) in ``directory``, sorted."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"image directory not found: {directory!r}")
    return [
        os.path.join(directory, fn)
        for fn in sorted(os.listdir(directory))
        if fn.lower().endswith(SUPPORTED_IMAGES)
    ]
