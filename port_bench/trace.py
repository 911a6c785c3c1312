"""Profiled slices of a run and what the harness reads from them.

``torch.profiler`` (CUPTI) is on for a short slice of whole units of
work (requests, K-step calls) after the measured window, never during
it.  A slice is kept only when it passes two checks, because the
profiler has been seen to lose kernel events:

1. counts: each kernel family the cell names (``kernels/<family>.json``:
   name fragments and kernels a call) shows exactly calls x kernels a
   call, and, where the slice is of host calls that each launch the same
   kernels, its kernels are a whole multiple of its calls;
2. time: the union of the device's busy intervals is no longer than the
   CUDA-event time of the slice (1% and 50 us of slack).

A slice that fails is run again, ``TRIES`` times at most; each failure
is reported on standard error, and ``profile`` returns None when none
passed.  The harness's host spans are ``record_function`` ranges, so
they sit on the profiler's timeline beside the device's intervals: an
idle gap is labelled by the innermost span around its midpoint.
"""

from __future__ import annotations

import json
import sys
import time
from contextlib import nullcontext
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent / "kernels"
SLICE_SPAN = "bench.slice"
TRIES = 5
TIME_SLACK = (1.01, 50.0)  # factor, microseconds


def family(name: str) -> dict:
    """A kernel family's file: ``{"match": [fragments], "per_call": n}``."""
    return json.loads((KERNELS_DIR / f"{name}.json").read_text())


def in_family(kernel: str, fam: dict) -> bool:
    return any(m in kernel for m in fam["match"])


class Spans:
    """The harness's host spans: ``record_function`` ranges while a
    slice is profiled, nothing otherwise."""

    names = ("request", "client.next", "prefetch.next", "step.call",
             "readback")

    def __init__(self):
        self.active = False

    def __call__(self, name: str):
        if not self.active:
            return nullcontext()
        import torch

        return torch.profiler.record_function(name)


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals: list, lo: float, hi: float) -> list:
    return [[max(s, lo), min(e, hi)] for s, e in intervals
            if min(e, hi) > max(s, lo)]


def short_name(name: str, limit: int = 96) -> str:
    name = name.removeprefix("void ")
    for cut in ("(", "<"):
        if cut in name and not name.startswith(cut):
            name = name.split(cut, 1)[0]
    return name[:limit]


def reduce(events: list, *, units: int, families: dict,
           calls: int, event_ms: float) -> dict:
    """What a slice shows: busy and window seconds, each family's count
    and device seconds, the top device operations and the idle gaps by
    host span; ``ok`` and ``why`` say whether it passed the checks.
    ``events``: (start_us, end_us, name, on_device) of the profile;
    ``units``: the units of work the families' counts are per (tile
    batches, steps); ``calls``: host calls that each launch the same
    kernels (0: no such check)."""
    window = [(s, e) for s, e, n, dev in events
              if not dev and n == SLICE_SPAN]
    if not window:
        return {"ok": False, "why": "no slice span in the profile"}
    lo, hi = window[0]
    spans = [(s, e, n) for s, e, n, dev in events
             if not dev and n in Spans.names]
    device = [(s, e, n) for s, e, n, dev in events
              if dev and n != SLICE_SPAN and n not in Spans.names]
    kernels = [(s, e, n) for s, e, n in device
               if not n.startswith(("Memcpy", "Memset"))]
    busy = _clip(_union([(s, e) for s, e, _ in device]), lo, hi)
    busy_us = sum(e - s for s, e in busy)
    out = {"busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6,
           "event_ms": event_ms, "units": units, "kernels": len(kernels),
           "families": {}}
    why = []
    if not kernels:
        why.append("no kernel event")
    for fname, calls_per_unit in families.items():
        fam = family(fname)
        hits = [(s, e) for s, e, n in kernels if in_family(n, fam)]
        want = units * calls_per_unit * fam["per_call"]
        out["families"][fname] = {
            "count": len(hits), "want": want,
            "calls": units * calls_per_unit,
            "device_s": sum(e - s for s, e in hits) / 1e6}
        if len(hits) != want:
            why.append(f"{fname}: {len(hits)} kernels, {want} wanted")
    if calls and len(kernels) % calls:
        why.append(f"{len(kernels)} kernels over {calls} calls")
    limit = TIME_SLACK[0] * event_ms * 1e3 + TIME_SLACK[1]
    if busy_us > limit:
        why.append(f"busy {busy_us / 1e3:.3f} ms > CUDA-event "
                   f"{event_ms:.3f} ms")
    by_name: dict = {}
    for s, e, n in device:
        key = short_name(n)
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
    out["device_ops"] = sorted(([k, v] for k, v in by_name.items()),
                               key=lambda kv: -kv[1])[:10]
    gaps: dict = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        around = [(e - s, n) for s, e, n in spans if s <= mid <= e]
        label = min(around)[1] if around else "between spans"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    out["idle_gaps"] = sorted(([k, v] for k, v in gaps.items()),
                              key=lambda kv: -kv[1])[:10]
    out["ok"], out["why"] = not why, "; ".join(why)
    return out


def profile(run_slice, *, units: int, families: dict, calls: int,
            spans: Spans, device) -> dict | None:
    """Profile ``run_slice()`` (``units`` whole units of work) until a
    slice passes the checks, ``TRIES`` times at most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    t0 = time.perf_counter()
    for attempt in range(1, TRIES + 1):
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        spans.active = True
        try:
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(SLICE_SPAN):
                    start.record()
                    run_slice()
                    end.record()
                    torch.cuda.synchronize(device)
        finally:
            spans.active = False
        events = [(e.time_range.start, e.time_range.end, e.name,
                   e.device_type == DeviceType.CUDA) for e in prof.events()]
        out = reduce(events, units=units, families=families, calls=calls,
                     event_ms=start.elapsed_time(end))
        out["tries"] = attempt
        if out["ok"]:
            print(f"trace: slice {attempt} passed; {len(events)} events, "
                  f"{time.perf_counter() - t0:.3f} s with the reduction",
                  file=sys.stderr, flush=True)
            return out
        print(f"trace: slice {attempt} of {TRIES} failed its checks: "
              f"{out['why']}", file=sys.stderr, flush=True)
    return None
