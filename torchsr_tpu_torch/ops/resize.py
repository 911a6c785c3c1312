"""Resampling over NHWC spatial dims: nearest upsampling and PIL bicubic.

``bicubic_resize`` is the port of the JAX package's
``torchsr_tpu/ops/resize.py``: PIL's antialiased bicubic resampler as
two matrix products, one per spatial axis, with the weight matrices
precomputed on the host (``resample_matrix``, PIL's kernel, window
clipping and per-pixel normalization).  With ``quantize`` it clamps
and rounds to the uint8 grid after each pass, width first, as PIL's
8-bit pipeline does.  The matrix products are plain ``torch.einsum``
(the JAX package leaves them to XLA too).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """``F.interpolate(scale_factor=factor, mode='nearest')`` on an
    NHWC tensor: every pixel is repeated ``factor`` x ``factor`` times.
    One broadcast copy; the result is a contiguous NHWC tensor."""
    *b, h, w, c = x.shape
    x = x[..., :, None, :, None, :].expand(*b, h, factor, w, factor, c)
    return x.reshape(*b, h * factor, w * factor, c)


def _cubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic convolution kernel (the PIL/Catmull-Rom variant)."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * (x3 - 5.0 * x2 + 8.0 * x - 4.0), 0.0),
    )


@functools.lru_cache(maxsize=256)
def resample_matrix(in_size: int, out_size: int) -> np.ndarray:
    """The (out_size, in_size) f32 matrix ``M`` with ``y = M @ x``
    resampling a length-``in_size`` signal with PIL ``Image.BICUBIC``
    semantics (antialiased when downscaling)."""
    if in_size < 1 or out_size < 1:
        raise ValueError(f"invalid resample sizes {in_size} -> {out_size}")
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        j = np.arange(xmin, xmax)
        w = _cubic_kernel((j + 0.5 - center) / filterscale)
        s = w.sum()
        if s != 0.0:
            w = w / s
        mat[i, xmin:xmax] = w
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _matrix_on(in_size: int, out_size: int,
               device: torch.device) -> torch.Tensor:
    """``resample_matrix`` as a tensor on ``device``, copied there once:
    a training step captured into a CUDA graph may not copy from the
    host.  Made outside inference mode, so every caller may use it."""
    with torch.inference_mode(False):
        return torch.from_numpy(resample_matrix(in_size, out_size)).to(
            device)


# 1/255 as an f32 constant.  The JAX package writes ``/ 255.0``, and XLA
# compiles that as a multiply by the f32 reciprocal; a true division
# differs from that product by one ulp for 126 of the 256 uint8 values,
# so the port multiplies by the same constant.
INV_255 = float(np.float32(1) / np.float32(255))


def _quantize_pixels(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 1] and snap to the uint8 grid (k/255 values)."""
    return torch.round(x.clamp(0.0, 1.0) * 255.0) * INV_255


def bicubic_resize(
    x: torch.Tensor, out_hw: tuple[int, int], *, quantize: bool = False,
) -> torch.Tensor:
    """Resize (..., H, W, C) images with PIL-compatible bicubic
    resampling, in f32 (uint8 inputs are read as k/255).  ``quantize``
    emulates PIL's uint8 pipeline: clamp and round after the width pass
    and again after the height pass."""
    if not x.is_floating_point():
        x = x.float() * INV_255
    else:
        x = x.float()
    h_in, w_in = x.shape[-3], x.shape[-2]
    h_out, w_out = out_hw
    if w_in != w_out:
        x = torch.einsum("ow,...hwc->...hoc",
                         _matrix_on(w_in, w_out, x.device), x)
        if quantize:
            x = _quantize_pixels(x)
    if h_in != h_out:
        x = torch.einsum("oh,...hwc->...owc",
                         _matrix_on(h_in, h_out, x.device), x)
        if quantize:
            x = _quantize_pixels(x)
    return x
