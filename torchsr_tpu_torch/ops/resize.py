"""Nearest-neighbour upsampling over NHWC spatial dims."""

from __future__ import annotations

import torch


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """``F.interpolate(scale_factor=factor, mode='nearest')`` on an
    NHWC tensor: every pixel is repeated ``factor`` x ``factor`` times.
    One broadcast copy; the result is a contiguous NHWC tensor."""
    *b, h, w, c = x.shape
    x = x[..., :, None, :, None, :].expand(*b, h, factor, w, factor, c)
    return x.reshape(*b, h * factor, w * factor, c)
