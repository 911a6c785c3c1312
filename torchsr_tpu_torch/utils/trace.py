"""The port's own spans and counters.

``span(name, device=False, **attrs)`` marks a stretch of host code,
named ``<layer>.<what>`` (``serve.request``, ``tiled.cut``,
``train.call``...).  With no ``torch.profiler`` recording on the calling
thread it costs one flag check and returns a shared no-op context: no
allocation, no clock read, no CUDA event.  While a profiler records, a
span

* opens a ``torch._C._profiler._RecordFunctionFast`` range, so that it
  sits on the profiler's timeline (and in every trace the profiler
  exports) as a plain ``cpu_op``.  ``torch.profiler.record_function``
  would make a user annotation, which the CUDA profiler mirrors onto
  the device's timeline, where it would count as device time;
* keeps a record in an in-memory ring of 8192 (``records()``): the name,
  start and end in ``time.time_ns()`` (the profiler's own clock, so a
  record can be laid over any profile), the id of the span open around
  it on the thread, the id of the outermost one (the root: one request,
  one training call), and its attrs.  When the ring is full the oldest
  record goes, and ``dropped()`` says how many went since the ring was
  last emptied: a reader of whole roots (a call and its replays) reads
  nothing while it is above 0;
* with ``device`` (``True`` for the current CUDA device, or a
  ``torch.device``; a CPU device times nothing) also records a pair of
  CUDA timing events on that device's current stream.  The device time
  between them (``Span.device_ms``) is resolved when it is read, never
  while the span runs.

``count(name, n=1)`` adds to a process counter, always on;
``counters()`` reads them (the service's ``/metrics``).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch
from torch.autograd import _profiler_enabled

# absent from some builds: the records are kept without the range
_FAST = getattr(torch._C._profiler, "_RecordFunctionFast", None)

_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=8192)
_counters: dict = {}
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span of a thread no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class Span:
    """One recorded span; ``device_ms`` is its device time (None without
    device timing)."""

    __slots__ = ("id", "name", "parent", "root", "attrs", "start_ns",
                 "end_ns", "_range", "_stream", "_events", "_device_ms")

    def __init__(self, name: str, stream, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs
        self._stream = stream
        self._events = None
        self._device_ms = None

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self._range = _FAST(self.name) if _FAST is not None else None
        if self._range is not None:
            self._range.__enter__()
        if self._stream is not None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _dropped
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record(self._stream)
        self._stream = None
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _local.stack.pop()
        with _lock:
            if len(_ring) == _ring.maxlen:
                _dropped += 1
            _ring.append(self)
        return False

    @property
    def device_ms(self) -> float | None:
        """Milliseconds of the stream between the span's two events
        (waits for the second); None for a span without them."""
        if self._events is not None and self._device_ms is None:
            self._events[1].synchronize()
            self._device_ms = self._events[0].elapsed_time(self._events[1])
        return self._device_ms

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"root={self.root}, attrs={self.attrs})")


def _stream_of(device):
    if device is True:
        return (torch.cuda.current_stream() if torch.cuda.is_available()
                else None)
    if isinstance(device, torch.device) and device.type == "cuda":
        return torch.cuda.current_stream(device)
    return None


def span(name: str, device: bool | torch.device = False, **attrs):
    """A context manager around host code: the shared no-op unless a
    profiler records on this thread (see the module's docstring)."""
    if not _profiler_enabled():
        return _OFF
    return Span(name, _stream_of(device), attrs)


def records(name: str | None = None) -> list:
    """The ring's finished spans, oldest first (only ``name``'s when
    given)."""
    with _lock:
        kept = list(_ring)
    return kept if name is None else [s for s in kept if s.name == name]


def clear() -> None:
    """Empty the ring."""
    global _dropped
    with _lock:
        _ring.clear()
        _dropped = 0


def dropped() -> int:
    """Records the full ring let go since it was last emptied."""
    with _lock:
        return _dropped


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """Every process counter, by name."""
    with _lock:
        return dict(_counters)
