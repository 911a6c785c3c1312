"""Cross-request dynamic tile batching for the serving daemon.

The port of the JAX package's ``infer/batching.py``.  The tiled serving
path (``infer/tiled.py``) fills the card by batching one frame's tiles,
but a 64 x 64 request is one tile, and it would pay a whole tile batch
of which all but one slot is padding.  With ``serve --batch-requests``
requests whose frames tile to fewer than ``tile_batch`` tiles put their
tiles into one shared queue; a single device worker drains up to
``batch`` tiles, across request boundaries, into one fixed-shape
forward, then hands each request its SR tiles back.

Design, as in JAX:

- The batcher owns no torch state: it calls an opaque ``forward(np.ndarray
  (B, t, t, 3)) -> np.ndarray (B, t*s, t*s, 3)`` that the caller supplies
  (in the server: the graphed tile forward of ``infer/tiled.py``, the
  same CUDA graph the big-frame path replays, taken under the service's
  device lock).  The module is numpy and the standard library only.
- Tile extraction and the overlap-add composite run on the host, numpy
  mirrors of ``infer/tiled.py``: the same positions, the same quadratic
  blend window and the same 1e-8 weight floor (the device gather blend
  sums each pixel's tiles in the order this loop adds them).  The routing
  sends only frames that cannot fill a batch alone through here, so the
  composite is a handful of tile adds.
- Policy: the worker waits ``max_wait_ms`` after the first queued tile
  for the batch to fill, then launches with whatever arrived.  Under
  sustained load the next batch fills while the previous call runs.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from torchsr_tpu_torch.infer.tiled import _blend_window, _positions


def extract_tiles(image: np.ndarray, tile: int, overlap: int):
    """Cover an ``(H, W, 3)`` float32 image with fixed-size tiles.

    Host mirror of the extraction in ``infer/tiled.py`` ``tiled_upscale``
    (same reflect pad for sub-tile images, same flush-clamped
    positions).  Returns ``(tiles (N, tile, tile, 3), grid, padded_hw)``
    where ``grid`` is the list of LR (y, x) tile origins.
    """
    if not 0 <= overlap < tile:
        raise ValueError(
            f"overlap must satisfy 0 <= overlap < tile, got "
            f"overlap={overlap} tile={tile}"
        )
    h, w = image.shape[:2]
    pad_h = max(tile - h, 0)
    pad_w = max(tile - w, 0)
    if pad_h or pad_w:
        image = np.pad(
            image, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect"
        )
    ph, pw = image.shape[:2]
    stride = tile - overlap
    ys = _positions(ph, tile, stride)
    xs = _positions(pw, tile, stride)
    grid = [(y, x) for y in ys for x in xs]
    tiles = np.stack(
        [image[y : y + tile, x : x + tile] for (y, x) in grid]
    ).astype(np.float32, copy=False)
    return tiles, grid, (ph, pw)


def count_tiles(h: int, w: int, tile: int, overlap: int) -> int:
    """Tiles a frame of LR size (h, w) needs — the routing predicate
    (no extraction, just the position arithmetic)."""
    ph, pw = max(h, tile), max(w, tile)
    stride = tile - overlap
    return len(_positions(ph, tile, stride)) * len(
        _positions(pw, tile, stride)
    )


def composite_tiles(
    sr_tiles: np.ndarray,
    grid,
    padded_hw,
    out_hw,
    tile: int,
    overlap: int,
    scale: int,
) -> np.ndarray:
    """Overlap-add the SR tiles back into a frame (host mirror of
    ``infer/tiled.py`` ``blend_tiles``: identical blend window,
    accumulation order, and 1e-8 weight floor)."""
    ph, pw = padded_hw
    t4 = tile * scale
    window = _blend_window(t4, overlap * scale)  # (t4, t4, 1) float32
    acc = np.zeros((ph * scale, pw * scale, 3), np.float32)
    wacc = np.full((ph * scale, pw * scale, 1), 1e-8, np.float32)
    for sr, (y, x) in zip(sr_tiles, grid):
        y4, x4 = y * scale, x * scale
        acc[y4 : y4 + t4, x4 : x4 + t4] += sr * window
        wacc[y4 : y4 + t4, x4 : x4 + t4] += window
    out = acc / wacc
    h, w = out_hw
    return out[: h * scale, : w * scale]


class _Job:
    """One request's tiles and its result buffer."""

    __slots__ = ("tiles", "out", "remaining", "event", "error")

    def __init__(self, tiles: np.ndarray, t4: int):
        n = tiles.shape[0]
        self.tiles = tiles
        self.out = np.empty((n, t4, t4, tiles.shape[-1]), np.float32)
        self.remaining = n
        self.event = threading.Event()
        self.error: BaseException | None = None


class TileBatcher:
    """Coalesces tiles from concurrent requests into shared forwards.

    ``forward`` runs the device work: a callable taking a float32
    ``(batch, tile, tile, 3)`` array and returning the SR batch
    ``(batch, tile*scale, tile*scale, 3)`` as float32 — the caller
    wraps the device copies, the forward and any device lock inside it.

    ``upscale_tiles(tiles)`` blocks until every submitted tile has been
    upscaled and returns the SR tiles in submission order.  Tiles from
    one request may be split across device calls and share calls with
    other requests; short batches (queue drained, ``max_wait_ms``
    expired) are padded by repeating the final tile, and the padding is
    discarded before scatter-back.
    """

    def __init__(
        self,
        forward,
        tile: int,
        scale: int,
        batch: int,
        max_wait_ms: float = 2.0,
    ):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self._forward = forward
        self.tile = int(tile)
        self.scale = int(scale)
        self.batch = int(batch)
        self.max_wait_ms = float(max_wait_ms)
        self._cond = threading.Condition()
        self._pending: deque[list] = deque()  # [job, next_tile_idx]
        self._queued = 0  # tiles waiting (across jobs)
        self._stop = False
        # stats (read via stats(); _cond guards writes)
        self._calls = 0
        self._tiles_done = 0
        self._worker = threading.Thread(
            target=self._run_worker, name="tile-batcher", daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------- API

    def upscale_tiles(self, tiles: np.ndarray) -> np.ndarray:
        """Blockingly upscale ``(N, tile, tile, 3)`` float32 tiles."""
        if tiles.ndim != 4 or tiles.shape[1:3] != (self.tile, self.tile):
            raise ValueError(
                f"expected (N, {self.tile}, {self.tile}, C) tiles, got "
                f"{tiles.shape}"
            )
        t4 = self.tile * self.scale
        if tiles.shape[0] == 0:
            return np.empty((0, t4, t4, tiles.shape[-1]), np.float32)
        job = _Job(np.ascontiguousarray(tiles, np.float32), t4)
        with self._cond:
            if self._stop:
                raise RuntimeError("TileBatcher is closed")
            self._pending.append([job, 0])
            self._queued += tiles.shape[0]
            self._cond.notify_all()
        job.event.wait()
        if job.error is not None:
            raise job.error
        return job.out

    def stats(self) -> dict:
        """Counters: device calls, tiles upscaled, mean batch fill."""
        with self._cond:
            calls, tiles = self._calls, self._tiles_done
        return {
            "batched_calls": calls,
            "batched_tiles": tiles,
            "batch_fill_mean": (
                round(tiles / (calls * self.batch), 3) if calls else None
            ),
        }

    def close(self) -> None:
        """Stop the worker; pending jobs fail with RuntimeError."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._worker.join(timeout=10)

    # ---------------------------------------------------------- worker

    def _take(self, cap: int):
        """Pop up to ``cap`` tiles across job boundaries (under _cond)."""
        items = []
        taken = 0
        while self._pending and taken < cap:
            entry = self._pending[0]
            job, idx = entry
            n = min(job.tiles.shape[0] - idx, cap - taken)
            items.append((job, idx, idx + n))
            entry[1] += n
            taken += n
            if entry[1] == job.tiles.shape[0]:
                self._pending.popleft()
        self._queued -= taken
        return items

    def _run_worker(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait()
                if self._stop:
                    # fail whatever is still queued so no caller hangs
                    items = self._take(self._queued)
                    for job, _, _ in items:
                        job.error = RuntimeError("TileBatcher closed")
                        job.event.set()
                    return
                if self._queued < self.batch and self.max_wait_ms > 0:
                    deadline = time.monotonic() + self.max_wait_ms / 1e3
                    while self._queued < self.batch and not self._stop:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cond.wait(left)
                items = self._take(self.batch)
            if items:
                self._run_batch(items)

    def _run_batch(self, items) -> None:
        # Everything that can raise lives in this try: a failure (bad
        # forward, wrong output shape, batch-assembly bug) must fail
        # the waiting CALLERS, never kill the worker thread — a dead
        # worker would hang every future request.
        t4 = self.tile * self.scale
        try:
            k = sum(stop - start for _, start, stop in items)
            parts = [
                job.tiles[start:stop] for job, start, stop in items
            ]
            if k < self.batch:
                # pad with copies of the final tile: a fixed shape
                # keeps the one captured graph; padding output
                # is discarded
                parts.append(
                    np.broadcast_to(
                        parts[-1][-1],
                        (self.batch - k,) + parts[-1].shape[1:],
                    )
                )
            batch = np.concatenate(parts, axis=0)
            sr = np.asarray(self._forward(batch), np.float32)
            if sr.shape != (self.batch, t4, t4, batch.shape[-1]):
                raise ValueError(
                    f"forward returned {sr.shape}, expected "
                    f"({self.batch}, {t4}, {t4}, {batch.shape[-1]})"
                )
        except BaseException as exc:  # propagate to every waiting caller
            for job, _, _ in items:
                job.error = exc
                job.event.set()
            return
        # Bump the call counter BEFORE waking any caller so that a
        # stats() read taken immediately after upscale_tiles() returns
        # observes a consistent (calls, tiles) pair.
        with self._cond:
            self._calls += 1
        off = 0
        for job, start, stop in items:
            n = stop - start
            job.out[start:stop] = sr[off : off + n]
            off += n
            finished = False
            with self._cond:
                job.remaining -= n
                finished = job.remaining == 0
                self._tiles_done += n
            if finished:
                job.event.set()
