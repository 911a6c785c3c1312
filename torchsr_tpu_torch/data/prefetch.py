"""Background host-to-device prefetch.

The port of ``torchsr_tpu/data/prefetch.py``: a thread assembles the
next batches and starts their copies while the device computes.  On
CUDA each host array is put in pinned (page-locked) memory and copied
with ``non_blocking=True``; the copy is queued on the current stream,
so the step that consumes it is ordered after it.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

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
