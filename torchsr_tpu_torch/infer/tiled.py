"""Tiled overlap-blend inference for arbitrary-size images.

The image is covered by fixed-size overlapping tiles, the generator runs
over the tiles in batches of ``tile_batch``, and the SR tiles are
blended back with a separable quadratic ramp over the overlap, so tile
seams are invisible.  All of it stays on the image's device.  The
semantics are those of the JAX package's ``infer/tiled.py``: positions
flush-clamped at the far edges, images smaller than a tile
reflect-padded, the last chunk padded with copies of tile (0, 0) that
carry weight 0, and the canvas's weight starting at 1e-8.

The work a frame costs the host does not grow with its tile count
beyond one copy in and one copy out a tile batch:

* the tiles are cut with one gather;
* on CUDA each tile batch is one replay of the generator captured into
  a ``torch.cuda.CUDAGraph`` for its static ``(tile_batch, tile, tile,
  3)`` input (``TileForward``, kept by ``GraphedForward`` per shape,
  compute dtype and RDB variant); on the CPU the module runs eagerly;
* the blend is a gather, not a loop over tiles: the SR tiles are laid
  side by side into one mosaic (tile (i, j) at block (i, j)) weighted
  by the window, and each output pixel sums the few tiles that cover
  it, at most K per axis (``_cover``), in the order of the JAX scan
  (row-major tile order).  Each (row slot, column slot) pair is a few
  device ops, so a frame is a few times K^2 of them whatever its tile
  count, and the result is the same bytes from call to call (no
  atomics).

While a profiler records, a frame's cut, each tile batch and the blend
are the spans ``tiled.cut`` (with the frame's tiles, slots and LR
pixels), ``tiled.batch`` and ``tiled.blend`` (``utils/trace.py``); the
counters ``tiles``, ``tile_slots``, ``tile_slot_px`` and ``tile_lr_px``
are always on.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from torchsr_tpu_torch.utils import trace

# LR tile size per model for serving (the JAX package's defaults; HAT's
# is its test configurations' tile_size, a whole number of its windows).
DEFAULT_SERVING_TILE = {"esrgan": 64, "srgan": 256, "hat": 256}


def _positions(size: int, tile: int, stride: int) -> list[int]:
    """Start offsets covering [0, size) with final tile clamped flush."""
    if size <= tile:
        return [0]
    pos = list(range(0, size - tile + 1, stride))
    if pos[-1] != size - tile:
        pos.append(size - tile)
    return pos


@functools.lru_cache(maxsize=32)
def _blend_ramp(size: int, ramp: int) -> np.ndarray:
    """One axis of the blending window: a quadratic ramp over ``ramp``
    pixels at each end, near-zero weight for a tile's outermost pixels
    (where conv padding makes its output wrong), while tiles flush with
    the image border still normalize exactly."""
    i = np.arange(size, dtype=np.float32)
    if ramp <= 0:
        return np.ones(size, np.float32)
    w = np.minimum.reduce(
        [np.ones(size, np.float32), (i + 1) / ramp, (size - i) / ramp]
    )
    return np.maximum(w, 1e-4) ** 2


def _blend_window(size: int, ramp: int) -> np.ndarray:
    """Separable 2-D blending window (size, size, 1), float32."""
    w = _blend_ramp(size, ramp)
    return np.outer(w, w)[:, :, None]


@functools.lru_cache(maxsize=64)
def _cover(size: int, tile: int, overlap: int, scale: int) -> tuple:
    """One axis of the gather blend for ``size`` LR pixels: one
    ``(pixels, rows, weights)`` per slot k, where slot k of output pixel
    p is the k-th tile (in increasing tile order) that covers p.
    ``pixels`` are the output pixels that have a k-th tile (None: every
    pixel, as for slot 0), ``rows`` that tile's mosaic row at each of
    them (``tile_index * tile * scale + offset``) and ``weights`` its
    window weight there.  A pixel has at most ceil(tile / stride) + 1
    slots (one more where the last tile is clamped flush)."""
    t4 = tile * scale
    pos = np.asarray(_positions(size, tile, tile - overlap)) * scale
    p = np.arange(size * scale)
    covers = (p[:, None] >= pos[None, :]) & (p[:, None] < pos[None, :] + t4)
    order = np.argsort(~covers, axis=1, kind="stable")
    ramp = _blend_ramp(t4, overlap * scale)
    slots = []
    for k in range(int(covers.sum(1).max())):
        valid = covers[p, order[:, k]]
        pix = p[valid]
        tiles = order[pix, k]
        offset = pix - pos[tiles]
        slots.append((None if valid.all() else pix.astype(np.int64),
                      (tiles * t4 + offset).astype(np.int64), ramp[offset]))
    return tuple(slots)


def _reflect_index(n_out: int, n: int, device) -> torch.Tensor:
    """Source rows of numpy's ``reflect`` padding of ``n`` rows to
    ``n_out``; any pad width, unlike ``F.pad``'s reflect mode."""
    i = torch.arange(n_out, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i % period
    return torch.where(i < n, i, period - i)


def blend_tiles(sr: torch.Tensor, padded_hw, tile: int, overlap: int,
                scale: int) -> torch.Tensor:
    """Overlap-add the SR tiles of one frame: ``sr`` (ny * nx, t4, t4,
    3) in row-major tile order over the padded LR frame ``padded_hw``;
    returns the (ph * scale, pw * scale, 3) blended canvas.

    The tiles are laid out as one mosaic (tile (i, j) at block (i, j))
    times the window, as the JAX scan multiplies each tile; then each
    (row slot, column slot) pair of ``_cover`` adds its tiles' values at
    the pixels that have both slots, in slot order, which is the scan's
    row-major tile order for every pixel.  Slot 0 covers every pixel;
    the later slots only the overlaps, so they touch a small part of the
    canvas.  Indices within an update are distinct: no atomics, the same
    bytes every call."""
    ph, pw = padded_hw
    t4 = tile * scale
    ny = len(_positions(ph, tile, tile - overlap))
    nx = len(_positions(pw, tile, tile - overlap))
    dev = sr.device
    ramp = torch.from_numpy(_blend_ramp(t4, overlap * scale)).to(dev)
    mosaic = sr.reshape(ny, nx, t4, t4, 3).permute(0, 2, 1, 3, 4)
    mosaic = mosaic.reshape(ny * t4, nx * t4, 3)
    window = ramp.repeat(ny)[:, None] * ramp.repeat(nx)[None, :]
    mosaic = mosaic * window[..., None]

    def on_device(slots):
        return [tuple(None if a is None else torch.from_numpy(a).to(dev)
                      for a in slot) for slot in slots]

    for py, iy, wy in on_device(_cover(ph, tile, overlap, scale)):
        band = mosaic.index_select(0, iy)
        for px, ix, wx in on_device(_cover(pw, tile, overlap, scale)):
            value = band.index_select(1, ix)
            weight = (wy[:, None] * wx[None, :])[..., None]
            if py is None and px is None:
                # slot (0, 0), first: every pixel's first tile starts the
                # sums (the scan's 0 + v and 1e-8 + w)
                acc, wacc = value, weight + 1e-8
                continue
            if py is None:
                where = (slice(None), px)
            elif px is None:
                where = (py,)
            else:
                where = (py[:, None], px[None, :])
            acc[where] += value
            wacc[where] += weight
    return acc / wacc


def cut_tiles(image: torch.Tensor, tile: int, overlap: int,
              tile_batch: int) -> tuple[torch.Tensor, int, tuple]:
    """The tiles of an ``(H, W, 3)`` image, in one gather: ``(N, tile,
    tile, 3)`` with N padded to whole batches of ``tile_batch`` by
    copies of tile (0, 0), the number of real tiles, and the (reflect-
    padded) size they cover.  Call under ``torch.inference_mode``."""
    if not 0 <= overlap < tile:
        raise ValueError(
            f"overlap must satisfy 0 <= overlap < tile, got "
            f"overlap={overlap} tile={tile} (the tiling stride is "
            f"tile - overlap and must stay positive)"
        )
    device = image.device
    h, w = image.shape[:2]
    ph, pw = max(h, tile), max(w, tile)
    stride = tile - overlap
    ys, xs = _positions(ph, tile, stride), _positions(pw, tile, stride)
    n_tiles = len(ys) * len(xs)
    n_padded = -(-n_tiles // tile_batch) * tile_batch
    trace.count("tiles", n_tiles)
    trace.count("tile_slots", n_padded)
    trace.count("tile_slot_px", n_padded * tile * tile)
    trace.count("tile_lr_px", h * w)
    with trace.span("tiled.cut", tiles=n_tiles, slots=n_padded,
                    slot_px=n_padded * tile * tile, lr_px=h * w):
        if h < tile or w < tile:
            rows = _reflect_index(ph, h, device)
            cols = _reflect_index(pw, w, device)
            image = image[rows[:, None], cols[None, :]]
        grid = [(y, x) for y in ys for x in xs]
        starts = torch.tensor(
            grid + [(0, 0)] * (n_padded - n_tiles), device=device
        )
        ar = torch.arange(tile, device=device)
        rows = starts[:, 0, None] + ar  # (N, tile)
        cols = starts[:, 1, None] + ar
        tiles = image[rows[:, :, None], cols[:, None, :]]
    return tiles, n_tiles, (ph, pw)


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
    NHWC and return float32; its result is copied out before the next
    call (a ``TileForward`` returns its graph's static output).  Returns
    ``(H*scale, W*scale, 3)`` float32 on the image's device."""
    h, w = image.shape[:2]
    with torch.inference_mode():
        tiles, n_tiles, padded = cut_tiles(image, tile, overlap, tile_batch)
        t4 = tile * scale
        sr = torch.empty((len(tiles), t4, t4, 3), device=image.device)
        for first in range(0, len(tiles), tile_batch):
            with trace.span("tiled.batch"):
                sr[first:first + tile_batch] = infer_fn(
                    tiles[first:first + tile_batch])
        # padded entries (index >= n_tiles) carry weight 0: left out
        with trace.span("tiled.blend"):
            out = blend_tiles(sr[:n_tiles], padded, tile, overlap, scale)
    return out[: h * scale, : w * scale]


class TileForward:
    """``module(x)`` captured into a CUDA graph for one static input
    shape; a call copies its batch into the graph's input, replays, and
    returns the graph's static output (overwritten by the next call).

    The capture follows ``train/graphs.py`` ``StepGraph``: an eager run
    on a side stream first (a real forward, whose launches count), then
    the capture under ``torch.inference_mode``; the launch counters a
    capture advances are taken back and added once per replay.  A
    capture that fails raises: the card never runs the tiles eagerly
    behind a graph's back.  Capture and replays run with ``device``
    current, on a stream of that device."""

    def __init__(self, module, shape: tuple, device: torch.device) -> None:
        from torchsr_tpu_torch.train import graphs

        self.shape = tuple(shape)
        self.device = torch.device(device)
        with torch.inference_mode(), torch.cuda.device(self.device):
            self.input = torch.zeros(self.shape, device=device)
            graphs.warm_up(module, self.input)
            torch.cuda.synchronize(device)
            self.graph = torch.cuda.CUDAGraph()
            before = graphs.launch_counts()
            try:
                # a capture stream of this device: torch.cuda.graph's
                # default one is made once, on whichever device was
                # current then
                with trace.span("graph.capture"), graphs.gc_paused(), \
                        torch.cuda.graph(
                            self.graph, stream=torch.cuda.Stream(self.device),
                            capture_error_mode="thread_local"):
                    self.output = module(self.input)
            except RuntimeError as exc:
                raise RuntimeError(
                    f"capturing the tile forward {self.shape} into a CUDA "
                    f"graph failed: {exc}") from exc
            finally:
                after = graphs.launch_counts()
                graphs.add_launch_counts(
                    {k: before[k] - after[k] for k in before})
        trace.count("graph_captures")
        self.launches = {k: after[k] - before[k] for k in before}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from torchsr_tpu_torch.train import graphs

        if tuple(x.shape) != self.shape:
            raise ValueError(f"this tile forward takes {self.shape}, got "
                             f"{tuple(x.shape)}")
        with torch.inference_mode(), torch.cuda.device(self.device):
            self.input.copy_(x)
            self.graph.replay()
        graphs.add_launch_counts(self.launches)
        trace.count("graph_replays")
        return self.output


class GraphedForward:
    """The ``infer_fn`` of tiled work on CUDA: each input shape replays
    a ``TileForward`` of the module, captured at its first call and kept
    by (shape, compute dtype, RDB variant knobs).  One object serves all
    of a service's tiled work (its frames and its batcher), so they share
    one graph and its memory pool per key.  ``eager`` is the module
    itself, for one-off shapes (a whole-image forward)."""

    def __init__(self, module, device: torch.device) -> None:
        self.eager = module
        self.device = torch.device(device)
        self._graphs: dict = {}
        self._lock = threading.Lock()

    def graph(self, shape) -> TileForward:
        from torchsr_tpu_torch.ops import rdb as rdb_ops

        key = (tuple(shape), getattr(self.eager, "compute_dtype", None),
               rdb_ops.EXT_KERNEL, rdb_ops.ILV_KERNEL)
        with self._lock:
            if key not in self._graphs:
                self._graphs[key] = TileForward(self.eager, shape,
                                                self.device)
            return self._graphs[key]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.graph(x.shape)(x)


def tile_forward(module, device: torch.device | str):
    """What tiles through ``module`` on ``device``: a ``GraphedForward``
    on CUDA, the module itself (eager) on the CPU."""
    device = torch.device(device)
    return GraphedForward(module, device) if device.type == "cuda" else module


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
    size switches to overlap-blend tiling.  A whole-image forward of a
    ``GraphedForward`` runs its module eagerly (one-off shapes are not
    captured).  Returns float32 in [0, 1] on the host."""
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
            out = getattr(infer_fn, "eager", infer_fn)(x[None])[0]
    return out.clamp(0.0, 1.0).cpu().numpy()
