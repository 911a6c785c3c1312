"""Background host-to-device prefetch.

The port of ``torchsr_tpu/data/prefetch.py``: a thread assembles the
next batches and starts their copies while the device computes.  On
CUDA each prefetcher owns a stream of its own (``_Copier``): each host
array is put in pinned (page-locked) memory and copied there with
``non_blocking=True``, and an event is recorded after the batch's
copies.  Before a batch is yielded, the consumer's current stream waits
on that event (so the step, and a captured step's copy into its static
inputs, read the batch only once it has landed), and each tensor is
marked as used on the consumer's stream (``record_stream``), so that
the caching allocator does not hand its memory to a later copy while
the step still reads it.  A copy so no longer waits behind the step
queued before it, as JAX's ``device_put`` does not.  On the CPU the
arrays are wrapped and moved as they are.
``prefetch_to_device_stacked`` feeds the trainer's multi-step programs:
full groups of K batches go in one copy on a leading step axis.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

_SENTINEL = object()


class _Copier:
    """A prefetcher's host-to-device copies: ``put`` on the producer
    thread starts them, ``take`` on the consumer's makes its current
    stream wait for them.  On CUDA the copies run on ``stream``, a
    stream of the copier's own."""

    def __init__(self, device: torch.device):
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def put(self, item: tuple):
        if self.stream is None:
            return tuple(torch.from_numpy(arr).to(self.device)
                         for arr in item)
        with torch.cuda.stream(self.stream):
            tensors = tuple(torch.from_numpy(arr).pin_memory().to(
                self.device, non_blocking=True) for arr in item)
            done = torch.cuda.Event()
            done.record(self.stream)
        return tensors, done

    def take(self, copied) -> tuple:
        if self.stream is None:
            return copied
        tensors, done = copied
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(done)
        for t in tensors:
            t.record_stream(consumer)
        return tensors


def _run(produce: Callable[[Callable], None], size: int,
         take: Callable) -> Iterator:
    """Run ``produce(put)`` on a thread, ``size`` items ahead, and yield
    ``take`` of each item it puts; the producer's exceptions reach the
    consumer."""
    q: queue.Queue = queue.Queue(maxsize=size)

    def producer() -> None:
        try:
            produce(q.put)
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
        yield take(item)
    thread.join()


def prefetch_to_device(
    iterator: Iterable, device: torch.device, size: int = 2,
) -> Iterator[tuple]:
    """Yield each tuple of host arrays from ``iterator`` as device
    tensors, ``size`` batches ahead.  Exceptions of the producer reach
    the consumer."""
    copier = _Copier(torch.device(device))

    def produce(put) -> None:
        for item in iterator:
            put(copier.put(tuple(item)))

    return _run(produce, size, copier.take)


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
    copier = _Copier(torch.device(device))

    def produce(put) -> None:
        buf: list[tuple] = []
        for item in iterator:
            buf.append(tuple(item))
            if len(buf) == steps_per_call and steps_per_call > 1:
                stacked = tuple(np.stack([b[i] for b in buf])
                                for i in range(len(buf[0])))
                put(("multi", copier.put(stacked)))
                buf = []
        for b in buf:
            put(("single", copier.put(b)))

    return _run(produce, size,
                lambda item: (item[0], copier.take(item[1])))
