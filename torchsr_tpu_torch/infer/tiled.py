"""Tiled overlap-blend inference for arbitrary-size images.

The image is covered by fixed-size overlapping tiles, the generator runs
over the tiles in batches of ``tile_batch``, and the SR tiles are
blended back with a separable quadratic ramp over the overlap, so tile
seams are invisible.  All of it stays on the image's device: the tiles
are cut with one gather, the batches run under
``torch.inference_mode()``, and the overlap-add accumulates into one
canvas that is divided once by the accumulated weight.  The semantics
are those of the JAX package's ``infer/tiled.py``: the last chunk is
padded with copies of tile (0, 0) that carry weight 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# LR tile size per model for serving (the JAX package's defaults).
DEFAULT_SERVING_TILE = {"esrgan": 64, "srgan": 256}


def _positions(size: int, tile: int, stride: int) -> list[int]:
    """Start offsets covering [0, size) with final tile clamped flush."""
    if size <= tile:
        return [0]
    pos = list(range(0, size - tile + 1, stride))
    if pos[-1] != size - tile:
        pos.append(size - tile)
    return pos


@functools.lru_cache(maxsize=32)
def _blend_window(size: int, ramp: int) -> np.ndarray:
    """Separable 2-D blending window: linear ramp over ``ramp`` pixels."""
    i = np.arange(size, dtype=np.float32)
    if ramp <= 0:
        w = np.ones(size, np.float32)
    else:
        w = np.minimum.reduce(
            [np.ones(size, np.float32), (i + 1) / ramp, (size - i) / ramp]
        )
        # Quadratic ramp: near-zero weight for the outermost tile pixels
        # (where conv padding makes the tile output wrong) while tiles
        # flush with the global image border still normalize exactly.
        w = np.maximum(w, 1e-4) ** 2
    return np.outer(w, w)[:, :, None]


def _reflect_index(n_out: int, n: int, device) -> torch.Tensor:
    """Source rows of numpy's ``reflect`` padding of ``n`` rows to
    ``n_out``; any pad width, unlike ``F.pad``'s reflect mode."""
    i = torch.arange(n_out, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i % period
    return torch.where(i < n, i, period - i)


def tiled_upscale(
    infer_fn,
    image: torch.Tensor,
    scale: int = 4,
    tile: int = 128,
    overlap: int = 16,
    tile_batch: int = 8,
) -> torch.Tensor:
    """Upscale an ``(H, W, 3)`` float image by ``scale`` with tiling.

    ``infer_fn(batch) -> batch*scale`` must accept ``(B, tile, tile, 3)``
    NHWC and return float32.  Returns ``(H*scale, W*scale, 3)`` float32
    on the image's device."""
    if not 0 <= overlap < tile:
        raise ValueError(
            f"overlap must satisfy 0 <= overlap < tile, got "
            f"overlap={overlap} tile={tile} (the tiling stride is "
            f"tile - overlap and must stay positive)"
        )
    device = image.device
    h, w = image.shape[:2]
    with torch.inference_mode():
        if h < tile or w < tile:
            rows = _reflect_index(max(h, tile), h, device)
            cols = _reflect_index(max(w, tile), w, device)
            image = image[rows[:, None], cols[None, :]]
        ph, pw = image.shape[:2]
        stride = tile - overlap
        grid = [(y, x) for y in _positions(ph, tile, stride)
                for x in _positions(pw, tile, stride)]
        n_tiles = len(grid)
        n_padded = -(-n_tiles // tile_batch) * tile_batch
        starts = torch.tensor(
            grid + [(0, 0)] * (n_padded - n_tiles), device=device
        )
        ar = torch.arange(tile, device=device)
        rows = starts[:, 0, None] + ar  # (N, tile)
        cols = starts[:, 1, None] + ar
        tiles = image[rows[:, :, None], cols[:, None, :]]  # (N, t, t, 3)

        t4 = tile * scale
        window = torch.from_numpy(
            _blend_window(t4, overlap * scale)
        ).to(device)
        acc = torch.zeros((ph * scale, pw * scale, 3), device=device)
        wacc = torch.full((ph * scale, pw * scale, 1), 1e-8, device=device)
        for first in range(0, n_padded, tile_batch):
            sr = infer_fn(tiles[first:first + tile_batch])
            # padded entries (index >= n_tiles) carry weight 0: skipped
            for j, (y, x) in enumerate(grid[first:first + tile_batch]):
                y4, x4 = y * scale, x * scale
                acc[y4:y4 + t4, x4:x4 + t4] += sr[j] * window
                wacc[y4:y4 + t4, x4:x4 + t4] += window
        out = acc / wacc
    return out[: h * scale, : w * scale]


def upscale_image(
    infer_fn,
    image: np.ndarray,
    scale: int = 4,
    tile: int = 0,
    overlap: int = 16,
    tile_batch: int = 8,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Upscale an HxWx3 uint8/float image; ``tile=0`` = single forward.

    ``tile=0`` is the reference's whole-image forward; a positive tile
    size switches to overlap-blend tiling.  Returns float32 in [0, 1]
    on the host."""
    arr = np.asarray(image)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    x = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)
    if tile and (x.shape[0] > tile or x.shape[1] > tile):
        out = tiled_upscale(
            infer_fn, x, scale=scale, tile=tile, overlap=overlap,
            tile_batch=tile_batch,
        )
    else:
        with torch.inference_mode():
            out = infer_fn(x[None])[0]
    return out.clamp(0.0, 1.0).cpu().numpy()
