"""Tiled inference with each frame's tile batches spread over devices.

The port of ``torchsr_tpu/infer/multichip.py``.  Tiles are independent
work, so a frame's tile batches run on several cards at once: the tiles
are cut and blended on the image's device as ``infer/tiled.py``
``tiled_upscale`` cuts and blends them (``cut_tiles``,
``blend_tiles``), and chunk j of ``tile_batch`` tiles runs on device j
mod n through that device's forward (on CUDA a ``TileForward`` graph of
a generator replica there).  The same tiles in the same chunks through
the same kernels and the same blend: the result equals
``tiled_upscale`` on one device bit for bit.  The chunks go out a round
at a time, one to each device: every chunk of a round is sent before
any forward of it runs, and the results come back after them.  A
cross-device copy runs on the source card's stream, behind what is
queued there, and orders both cards' streams, so a chunk sent behind
the image card's own forward, or behind another chunk's result, would
wait for it, and the cards would take turns.  Where the JAX package runs
the forward inside ``shard_map`` over its mesh, the port holds one
process with a replica a device: no collective, one copy in and one
out a chunk.
"""

from __future__ import annotations

import torch

from torchsr_tpu_torch.infer.tiled import (
    blend_tiles,
    cut_tiles,
    tile_forward,
)
from torchsr_tpu_torch.parallel.mesh import replicate_module


def sharded_forwards(module: torch.nn.Module, devices: list) -> list:
    """What ``tiled_upscale_sharded`` runs on each of ``devices``: a
    replica of ``module`` there, graphed on CUDA (``tile_forward``)."""
    return [tile_forward(replica, d)
            for replica, d in zip(replicate_module(module, devices),
                                  devices)]


def tiled_upscale_sharded(
    infer_fns: list,
    image: torch.Tensor,
    devices: list,
    scale: int = 4,
    tile: int = 128,
    overlap: int = 16,
    tile_batch: int = 8,
) -> torch.Tensor:
    """Upscale an ``(H, W, 3)`` float image by ``scale`` with tiling,
    chunk j of ``tile_batch`` tiles on ``devices[j % n]`` through
    ``infer_fns[j % n]``: one forward an entry of ``devices``, each
    called once a round, its result read at the round's end
    (``sharded_forwards``).  Returns ``(H*scale, W*scale, 3)`` float32
    on the image's device, equal to ``tiled_upscale`` with one of the
    forwards."""
    if len(infer_fns) != len(devices) or not devices:
        raise ValueError("one forward a device, at least one device")
    n = len(devices)
    h, w = image.shape[:2]
    with torch.inference_mode():
        tiles, n_tiles, padded = cut_tiles(image, tile, overlap, tile_batch)
        t4 = tile * scale
        sr = torch.empty((len(tiles), t4, t4, 3), device=image.device)
        firsts = range(0, len(tiles), tile_batch)
        for r in range(0, len(firsts), n):
            chunks = list(zip(firsts[r:r + n], infer_fns, devices))
            xs = [tiles[first:first + tile_batch].to(device)
                  for first, _, device in chunks]
            outs = [fn(x) for (_, fn, _), x in zip(chunks, xs)]
            for (first, _, _), y in zip(chunks, outs):
                sr[first:first + tile_batch].copy_(y)
        out = blend_tiles(sr[:n_tiles], padded, tile, overlap, scale)
    return out[: h * scale, : w * scale]
