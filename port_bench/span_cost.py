"""What the program's spans (``torchsr_tpu_torch/utils/trace.py``) do to
a cell's traced slice, and where the slice's idle time lies.

    python3 -m port_bench.span_cost --workload <cell> --seed <n> --seconds <s> [--slices N] [--kept-spans on|off]

Runs the cell once with ``--trace 1``, the program's spans on in the
slice the run keeps, or forced off there with ``--kept-spans off``.
After that slice, the same slice runs ``--slices`` times more with the program's spans on
and as many with ``trace.span`` forced off, in turns (on, off, off,
on, ...), each profiled and checked as ``trace.profile`` does; a port
without the spans runs both sides alike.  Prints one JSON line: each
slice's side, CUDA-event time, busy and window seconds, idle share (as
the harness reads ``device_idle_pct``) and idle gaps by host span, with
the idle split into the head (window start to the first device
operation), the tail (last device operation to window end) and the
gaps between device operations, counted by length (``GAP_EDGES_US``);
then the run's correctness, per-layer metrics and breakdown.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

from port_bench import harness
from port_bench import run as bench_run
from port_bench import trace as bench_trace

# edges of the idle gaps' length classes, microseconds
GAP_EDGES_US = (10.0, 100.0, 1000.0)


def idle_shape(events: list) -> dict:
    """The idle time of a profiled slice (``events`` as
    ``trace.reduce`` takes them) by where it lies, in microseconds."""
    window = [(s, e) for s, e, n, dev in events
              if not dev and n == bench_trace.SLICE_SPAN]
    busy = sorted((s, e) for s, e, n, dev in events
                  if dev and n != bench_trace.SLICE_SPAN
                  and n not in bench_trace.Spans.names)
    if not window or not busy:
        return {}
    lo, hi = window[0]
    count = [0] * (len(GAP_EDGES_US) + 1)
    gap_us = [0.0] * (len(GAP_EDGES_US) + 1)
    end = busy[0][1]
    for s, e in busy[1:]:
        if s > end:
            k = sum(s - end > edge for edge in GAP_EDGES_US)
            count[k] += 1
            gap_us[k] += s - end
        end = max(end, e)
    return {"head_us": busy[0][0] - lo, "tail_us": hi - end,
            "gaps": {"edges_us": GAP_EDGES_US, "count": count,
                     "us": gap_us}}


def measure(cell: str, seed: int, seconds: float, slices: int,
            kept_spans: str = "on") -> dict:
    harness.set_environment()
    import torch

    try:
        from torchsr_tpu_torch.utils import trace as program
    except ImportError:  # a port without spans: both sides run alike
        program = None

    original_reduce = bench_trace.reduce
    original_profile = bench_trace.profile
    shapes: list = []
    kept: list = []

    def reduce(events, **kw):
        shapes.append(idle_shape(events))
        return original_reduce(events, **kw)

    def one(side: str, got) -> dict:
        if got is None:
            return {"side": side, "passed": False}
        return {"side": side, "passed": True, "tries": got["tries"],
                "event_ms": got["event_ms"], "busy_s": got["busy_s"],
                "window_s": got["window_s"],
                "idle_pct": 100.0 * (1.0 - got["busy_s"] / got["window_s"]),
                "idle_gaps": got["idle_gaps"], **shapes[-1]}

    @contextlib.contextmanager
    def spans(side: str):
        if program is None or side == "on":
            yield
            return
        span = program.span
        program.span = lambda *a, **k: program._OFF
        try:
            yield
        finally:
            program.span = span

    def profile(run_slice, **kw):
        with spans(kept_spans):
            got = original_profile(run_slice, **kw)
        kept.append(one("kept", got))
        for side in (["on", "off", "off", "on"] * slices)[:2 * slices]:
            with spans(side):
                kept.append(one(side, original_profile(run_slice, **kw)))
        return got

    r = harness.Run.of(cell, seed=seed, seconds=seconds, trace=True,
                       device=torch.device("cuda", 0),
                       t_start=time.perf_counter())
    if program:
        program.clear()
    bench_trace.reduce, bench_trace.profile = reduce, profile
    try:
        line = bench_run.execute(r)
    finally:
        bench_trace.reduce, bench_trace.profile = (original_reduce,
                                                   original_profile)
    return {"cell": cell, "seed": seed, "card": harness.card_line(r.device),
            "spans": program is not None, "kept_spans": kept_spans,
            "slices": kept,
            "correct": line["correct"],
            "metrics": line["metrics"], "breakdown": line.get("breakdown")}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--slices", type=int, default=4)
    p.add_argument("--kept-spans", choices=("on", "off"), default="on")
    args = p.parse_args(argv)
    print(json.dumps(measure(args.workload, args.seed, args.seconds,
                             args.slices, args.kept_spans)), flush=True)


if __name__ == "__main__":
    main()
