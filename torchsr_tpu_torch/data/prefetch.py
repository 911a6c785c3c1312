"""Background host-to-device prefetch.

The port of ``torchsr_tpu/data/prefetch.py``: a thread assembles the
next batches and starts their copies while the device computes.  On
CUDA each host array is put in pinned (page-locked) memory and copied
with ``non_blocking=True``; the copy is queued on the current stream,
so the step that consumes it is ordered after it.
``prefetch_to_device_stacked`` feeds the trainer's multi-step programs:
full groups of K batches go in one copy on a leading step axis.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()


def _to_device(item: tuple, device: torch.device) -> tuple:
    if device.type != "cuda":
        return tuple(torch.from_numpy(arr).to(device) for arr in item)
    return tuple(torch.from_numpy(arr).pin_memory().to(device,
                                                       non_blocking=True)
                 for arr in item)


def prefetch_to_device(
    iterator: Iterable, device: torch.device, size: int = 2,
) -> Iterator[tuple]:
    """Yield each tuple of host arrays from ``iterator`` as device
    tensors, ``size`` batches ahead.  Exceptions of the producer reach
    the consumer."""
    q: queue.Queue = queue.Queue(maxsize=size)
    device = torch.device(device)

    def producer() -> None:
        try:
            for item in iterator:
                q.put(_to_device(tuple(item), device))
        except BaseException as exc:  # propagate to the consumer
            q.put(exc)
            return
        q.put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
    thread.join()


def prefetch_to_device_stacked(
    iterator: Iterable, device: torch.device, steps_per_call: int,
    size: int = 2,
) -> Iterator[tuple[str, tuple]]:
    """Yield device batches grouped for the multi-step programs.

    Full groups of ``steps_per_call`` host batches are stacked on a new
    leading step axis and copied once, yielding ``("multi",
    stacked_tuple)``; the epoch's ragged tail (fewer than
    ``steps_per_call`` batches left) is yielded per batch as
    ``("single", batch_tuple)``.  ``steps_per_call <= 1`` yields every
    batch as ``("single", ...)``.  Exceptions of the producer reach the
    consumer."""
    q: queue.Queue = queue.Queue(maxsize=size)
    device = torch.device(device)

    def producer() -> None:
        try:
            buf: list[tuple] = []
            for item in iterator:
                buf.append(tuple(item))
                if len(buf) == steps_per_call and steps_per_call > 1:
                    stacked = tuple(np.stack([b[i] for b in buf])
                                    for i in range(len(buf[0])))
                    q.put(("multi", _to_device(stacked, device)))
                    buf = []
            for b in buf:
                q.put(("single", _to_device(b, device)))
        except BaseException as exc:  # propagate to the consumer
            q.put(exc)
            return
        q.put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
    thread.join()
