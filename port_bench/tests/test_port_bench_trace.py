"""The reduction of a profiled slice to busy time, families, the
breakdown and its checks, on made-up event lists."""

from __future__ import annotations

from port_bench import trace

SLICE = (0.0, 1000.0, trace.SLICE_SPAN, False)


def kernels(name: str, starts, length: float = 10.0) -> list:
    return [(s, s + length, name, True) for s in starts]


def test_busy_union_and_idle_gaps_by_span():
    events = [SLICE, (100.0, 400.0, "step.call", False),
              (400.0, 1000.0, "readback", False)]
    events += kernels("void rdb_fwd_sm90::rdb_fwd_conv(int)", [0, 5, 200])
    events += [(600.0, 900.0, "Memcpy DtoH ", True)]
    out = trace.reduce(events, units=0, families={}, calls=0, event_ms=1.0)
    assert out["ok"], out["why"]
    assert abs(out["busy_s"] - (15 + 10 + 300) / 1e6) < 1e-12
    assert out["window_s"] == 1e-3
    gaps = dict(out["idle_gaps"])  # each gap by the span at its middle
    assert abs(gaps["step.call"] - (200 - 15) / 1e6) < 1e-12
    assert abs(gaps["readback"] - (600 - 210 + 1000 - 900) / 1e6) < 1e-12
    assert out["device_ops"][0][0] == "Memcpy DtoH "
    assert abs(dict(out["device_ops"])["rdb_fwd_sm90::rdb_fwd_conv"] - 30e-6) < 1e-15


def test_family_counts_must_be_whole():
    fam = trace.family("rdb_fwd")
    events = [SLICE] + kernels("rdb_fwd_sm90::rdb_fwd_prep<float>",
                               range(0, 20, 10))
    events += kernels("rdb_fwd_sm90::rdb_fwd_conv", range(100, 200, 10))
    good = trace.reduce(events, units=2, families={"rdb_fwd": 1}, calls=0,
                        event_ms=1.0)
    assert good["ok"] and good["families"]["rdb_fwd"]["count"] == 12
    assert fam["per_call"] == 6
    lost = trace.reduce(events[:-1], units=2, families={"rdb_fwd": 1},
                        calls=0, event_ms=1.0)
    assert not lost["ok"] and "11 kernels, 12 wanted" in lost["why"]


def test_kernels_per_call_and_time_checks():
    events = [SLICE] + kernels("k", range(0, 50, 10))
    assert not trace.reduce(events, units=0, families={}, calls=2,
                            event_ms=1.0)["ok"]
    assert trace.reduce(events, units=0, families={}, calls=5,
                        event_ms=1.0)["ok"]
    long = [SLICE] + kernels("k", range(0, 500, 100), length=90.0)
    slow = trace.reduce(long, units=0, families={}, calls=0, event_ms=0.2)
    assert not slow["ok"] and "CUDA-event" in slow["why"]


def test_span_annotations_on_the_device_are_not_kernels():
    events = [SLICE, (0.0, 500.0, "step.call", True)] + kernels("k", [0])
    out = trace.reduce(events, units=0, families={}, calls=1, event_ms=1.0)
    assert out["kernels"] == 1 and out["busy_s"] == 10e-6


def test_no_slice_span_fails():
    assert not trace.reduce(kernels("k", [0]), units=0, families={},
                            calls=0, event_ms=1.0)["ok"]
