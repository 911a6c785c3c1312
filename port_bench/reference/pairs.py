"""LR/HR training pairs from uint8 HR crops, as the training recipe
makes them: per-sample horizontal and vertical flips (torchvision's
RandomHorizontalFlip / RandomVerticalFlip), then PIL's antialiased
bicubic downscale by the scale factor on the 8-bit image (width pass,
then height pass, each rounded to the uint8 grid), read back as [0, 1]
floats.  The resampling weights follow Pillow's ``Resample.c``: the
Keys cubic with a = -0.5, support 2 x the scale, the window rounded to
whole pixels and clipped to the image, normalized per output pixel.
Departure: Pillow sums in fixed point; here the sums are f32 and the
rounding ``torch.round`` (half to even).
"""

from __future__ import annotations

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


def weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) f64 resampling matrix."""
    scale = in_size / out_size
    fs = max(scale, 1.0)
    support = 2.0 * fs
    mat = np.zeros((out_size, in_size))
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        j = np.arange(lo, hi)
        w = _cubic((j - center + 0.5) / fs)
        total = w.sum()
        mat[i, lo:hi] = w / total if total else w
    return mat


def _quantize(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x.clamp(0.0, 1.0) * 255.0) / 255.0


def downscale(hr: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] on the uint8 grid -> (B, 3, H/f, W/f)."""
    h, w = hr.shape[-2:]
    mw = torch.from_numpy(weights(w, w // factor)).float().to(hr.device)
    mh = torch.from_numpy(weights(h, h // factor)).float().to(hr.device)
    x = _quantize(torch.einsum("bchw,ow->bcho", hr, mw))
    return _quantize(torch.einsum("bchw,oh->bcow", x, mh))


def synthesize(crops_u8: torch.Tensor, flips: torch.Tensor,
               factor: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, S, 3) uint8 crops and (B, 2) flip bits -> (lr, hr) f32
    NCHW."""
    hr = crops_u8.permute(0, 3, 1, 2).float() / 255.0
    hflip = flips[:, 0].bool()[:, None, None, None]
    vflip = flips[:, 1].bool()[:, None, None, None]
    hr = torch.where(hflip, hr.flip(3), hr)
    hr = torch.where(vflip, hr.flip(2), hr)
    return downscale(hr, factor), hr
