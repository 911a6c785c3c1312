"""Sub-pixel shuffles on NHWC tensors, in torch's channel order.

The port of ``torchsr_tpu/ops/pixel_shuffle.py``.  ``nn.PixelShuffle``
works on NCHW; the port's activations are NHWC, so the shuffle is a
reshape and a permute here.  The channel order is torch's: input
channel ``c * r^2 + i * r + j`` goes to output channel ``c`` at
spatial offset ``(i, j)``, so the reference's SRGAN weights behave as
they do in the reference.
"""

from __future__ import annotations

import torch


def depth_to_space(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """``(..., H, W, C*r*r)`` -> ``(..., H*r, W*r, C)``."""
    *b, h, w, c = x.shape
    r = factor
    if c % (r * r):
        raise ValueError(f"channels {c} not divisible by factor^2 {r * r}")
    x = x.reshape(*b, h, w, c // (r * r), r, r)
    nb = len(b)
    # (..., h, w, c, i, j) -> (..., h, i, w, j, c)
    x = x.permute(*range(nb), nb, nb + 3, nb + 1, nb + 4, nb + 2)
    return x.reshape(*b, h * r, w * r, c // (r * r))


def space_to_depth(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """The inverse of :func:`depth_to_space`."""
    *b, h, w, c = x.shape
    r = factor
    if h % r or w % r:
        raise ValueError(f"spatial dims ({h}, {w}) not divisible by {r}")
    x = x.reshape(*b, h // r, r, w // r, r, c)
    nb = len(b)
    # (..., h, i, w, j, c) -> (..., h, w, c, i, j)
    x = x.permute(*range(nb), nb, nb + 2, nb + 4, nb + 1, nb + 3)
    return x.reshape(*b, h // r, w // r, c * r * r)
