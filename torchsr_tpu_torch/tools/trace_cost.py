"""What the port's spans and counters (``utils/trace.py``) cost the host.

    python -m torchsr_tpu_torch.tools.trace_cost

Prints one JSON line: microseconds a span costs with no profiler (the
shared no-op, with and without attrs), a ``count()``, and a span while
a CPU profiler records (the range and the record), each the median of
five timings of 200,000 spans (10,000 under the profiler).  What the
spans do to a cell's traced slice on the card is
``port_bench/span_cost.py``'s.
"""

from __future__ import annotations

import json
import statistics
import time

from torchsr_tpu_torch.utils import trace


def _per_span_us(fn, n: int) -> float:
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(n)
        times.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(times)


def host_costs(n: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    def bare(m):
        for _ in range(m):
            with trace.span("cost.bare"):
                pass

    def attrs(m):
        for _ in range(m):
            with trace.span("cost.attrs", lr_h=1080, lr_w=1920):
                pass

    def count(m):
        for _ in range(m):
            trace.count("cost.count")

    def empty(m):
        for _ in range(m):
            pass

    out = {"loop_us": _per_span_us(empty, n),
           "span_off_us": _per_span_us(bare, n),
           "span_off_attrs_us": _per_span_us(attrs, n),
           "count_us": _per_span_us(count, n)}
    with profile(activities=[ProfilerActivity.CPU]):
        out["span_on_us"] = _per_span_us(attrs, max(n // 20, 1))
    trace.clear()
    out["torch"] = torch.__version__
    return out


def main() -> None:
    print(json.dumps(host_costs(200_000)), flush=True)


if __name__ == "__main__":
    main()
