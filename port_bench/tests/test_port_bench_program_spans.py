"""The readers of the port's own spans (``tile_useful_pct.serve``,
``copy_out_ms_per_request.serve``, ``host_gap_ms_per_call.train``)
against synthetic records, and with no slice, no records or records
the port's ring let go."""

from __future__ import annotations

import builtins
from types import SimpleNamespace

import pytest

from port_bench import harness

READERS = ("tile_useful_pct.serve", "copy_out_ms_per_request.serve",
           "host_gap_ms_per_call.train")


def _span(name, id_, parent=None, device_ms=None, **attrs):
    return SimpleNamespace(name=name, id=id_, parent=parent,
                           root=parent or id_, device_ms=device_ms,
                           attrs=attrs)


SERVE = [
    _span("serve.request", 1, lr_h=1080, lr_w=1920),
    _span("tiled.cut", 2, 1, tiles=700, slots=704, slot_px=704 * 4096,
          lr_px=1080 * 1920),
    _span("serve.copy_out", 3, 1, device_ms=44.0),
    _span("serve.request", 4, lr_h=20, lr_w=30),
    _span("tiled.cut", 5, 4, tiles=4, slots=16, slot_px=16 * 4096,
          lr_px=20 * 30),
    _span("serve.copy_out", 6, 4, device_ms=2.0),
]
TRAIN = [
    _span("train.call", 1, device_ms=100.0, phase="psnr", k=2),
    _span("train.replay", 2, 1, device_ms=45.0),
    _span("train.replay", 3, 1, device_ms=46.0),
    _span("train.call", 4, device_ms=95.0, phase="psnr", k=2),
    _span("train.replay", 5, 4, device_ms=44.0),
    _span("train.replay", 6, 4, device_ms=44.5),
    _span("train.capture", 7, 4),
]


@pytest.fixture
def recorded(monkeypatch):
    """The port's ring replaced by ``spans``, of which ``dropped`` went."""
    from torchsr_tpu_torch.utils import trace

    def use(spans, dropped=0):
        monkeypatch.setattr(trace, "records", lambda name=None: [
            s for s in spans if name is None or s.name == name])
        monkeypatch.setattr(trace, "dropped", lambda: dropped)
    return use


@pytest.mark.parametrize("name, spans, want", [
    ("tile_useful_pct.serve", SERVE,
     100.0 * (1080 * 1920 + 600) / (720 * 4096)),
    ("copy_out_ms_per_request.serve", SERVE, 23.0),
    ("host_gap_ms_per_call.train", TRAIN, ((100 - 91) + (95 - 88.5)) / 2),
])
def test_reader_on_synthetic_records(recorded, name, spans, want):
    recorded(spans)
    got = harness.metric_reader(name).read({"slice": {"ok": True},
                                            "window": {}})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_without_slice_or_records(recorded, name):
    reader = harness.metric_reader(name)
    recorded(SERVE + TRAIN)
    assert reader.read({"slice": None, "window": {}}) is None
    recorded([])
    assert reader.read({"slice": {"ok": True}, "window": {}}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_when_the_ring_let_records_go(recorded, name):
    # the oldest records go first: a call kept without its first replays
    # would read their time as outside the graphs
    reader = harness.metric_reader(name)
    recorded((SERVE + TRAIN)[1:], dropped=1)
    assert reader.read({"slice": {"ok": True}, "window": {}}) is None
    recorded((SERVE + TRAIN)[1:])
    assert reader.read({"slice": {"ok": True}, "window": {}}) is not None


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_none_on_a_port_without_spans(monkeypatch, name):
    real_import = builtins.__import__

    def no_trace(module, globals=None, locals=None, fromlist=(), level=0):
        if module == "torchsr_tpu_torch.utils" and "trace" in (fromlist
                                                                or ()):
            raise ImportError("no trace module")
        return real_import(module, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert harness.metric_reader(name).read(
        {"slice": {"ok": True}, "window": {}}) is None


def test_span_cost_splits_a_slices_idle_by_where_it_lies():
    from port_bench import span_cost

    events = [(0.0, 1000.0, "bench.slice", False),
              (0.0, 1000.0, "bench.slice", True),
              (100.0, 900.0, "step.call", True),
              (20.0, 100.0, "k", True), (105.0, 200.0, "k", True),
              (150.0, 300.0, "k", True), (350.0, 400.0, "k", True),
              (600.0, 700.0, "k", True), (700.5, 990.0, "k", True)]
    shape = span_cost.idle_shape(events)
    assert shape["head_us"] == 20.0 and shape["tail_us"] == 10.0
    # gaps of 5 and 0.5, 50, 200 us; none above 1 ms
    assert shape["gaps"]["count"] == [2, 1, 1, 0]
    assert shape["gaps"]["us"] == pytest.approx([5.5, 50.0, 200.0, 0.0])
    assert span_cost.idle_shape(events[:1]) == {}
