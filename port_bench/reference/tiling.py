"""Tiled upscaling of a frame of any size, as the service serves it.

The frame (uint8, H x W x 3) is read as [0, 1] floats and covered by
``tile`` x ``tile`` tiles at a stride of ``tile - overlap``, the last
tile of each axis moved flush with the far edge; a frame smaller than a
tile is first extended by mirror reflection (numpy's ``reflect``).
Each tile is upscaled by ``net``.  The upscaled tiles are blended, in
row-major tile order, with a separable window: per axis
``max(min(1, (i + 1) / r, (n - i) / r), 1e-4) ** 2`` over the upscaled
tile's n pixels with ``r = overlap x scale``; the weights of a pixel
start at 1e-8.  The blend is cropped to the frame's upscaled size,
clamped to [0, 1] and rounded to uint8 (``floor(255 v + 0.5)``).
"""

from __future__ import annotations

import numpy as np
import torch


def positions(size: int, tile: int, stride: int) -> list[int]:
    if size <= tile:
        return [0]
    pos = list(range(0, size - tile + 1, stride))
    if pos[-1] != size - tile:
        pos.append(size - tile)
    return pos


def window(n: int, ramp: int, device) -> torch.Tensor:
    i = np.arange(n, dtype=np.float64)
    if ramp <= 0:
        w = np.ones(n)
    else:
        w = np.minimum(np.minimum(1.0, (i + 1) / ramp), (n - i) / ramp)
        w = np.maximum(w, 1e-4) ** 2
    w = torch.from_numpy(w.astype(np.float32)).to(device)
    return w[:, None] * w[None, :]


def _reflect(n_out: int, n: int) -> np.ndarray:
    return np.pad(np.arange(n), (0, n_out - n), mode="reflect")


def upscale(frame_u8: torch.Tensor, net, *, scale: int, tile: int,
            overlap: int, batch: int) -> torch.Tensor:
    """``net``: (N, 3, tile, tile) -> (N, 3, tile*scale, tile*scale).
    Returns the (H*scale, W*scale, 3) uint8 frame on ``frame_u8``'s
    device."""
    h, w = frame_u8.shape[:2]
    x = frame_u8.permute(2, 0, 1).float() / 255.0
    if h < tile or w < tile:
        rows = torch.from_numpy(_reflect(max(h, tile), h)).to(x.device)
        cols = torch.from_numpy(_reflect(max(w, tile), w)).to(x.device)
        x = x[:, rows][:, :, cols]
    ph, pw = x.shape[1:]
    stride = tile - overlap
    grid = [(y, z) for y in positions(ph, tile, stride)
            for z in positions(pw, tile, stride)]
    t4 = tile * scale
    win = window(t4, overlap * scale, x.device)
    acc = torch.zeros((3, ph * scale, pw * scale), device=x.device)
    wacc = torch.full((ph * scale, pw * scale), 1e-8, device=x.device)
    for first in range(0, len(grid), batch):
        part = grid[first:first + batch]
        tiles = torch.stack([x[:, y:y + tile, z:z + tile] for y, z in part])
        sr = net(tiles)
        for (y, z), t in zip(part, sr):
            ys, zs = slice(y * scale, y * scale + t4), slice(z * scale,
                                                             z * scale + t4)
            acc[:, ys, zs] += t * win
            wacc[ys, zs] += win
    out = (acc / wacc)[:, :h * scale, :w * scale]
    out = torch.floor(out.clamp(0.0, 1.0) * 255.0 + 0.5)
    return out.to(torch.uint8).permute(1, 2, 0)
