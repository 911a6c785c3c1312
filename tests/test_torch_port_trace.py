"""The port's spans and counters (``torchsr_tpu_torch/utils/trace.py``)
on the CPU: the shared no-op with no profiler; the records' tree, their
``cpu_op`` ranges and their clock under ``torch.profiler``; and the
spans of the three instrumented paths (the tiler, the service's
request, the trainer's K-step call), the ring's overflow and the
service's lock timings in ``/metrics``."""

import json
import sys
import threading
import time
import types
from argparse import Namespace
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torchsr_tpu_torch.infer import server
from torchsr_tpu_torch.infer.tiled import cut_tiles
from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
from torchsr_tpu_torch.tools import trace_cost
from torchsr_tpu_torch.train.trainer import SRGANTrainer
from torchsr_tpu_torch.utils import trace
from torchsr_tpu_torch.utils.checkpoint import save_checkpoint

# The harness's own span names (port_bench/trace.py Spans.names and its
# slice): the program's must differ from them.
HARNESS_SPANS = {"request", "client.next", "prefetch.next", "step.call",
                 "readback", "bench.slice"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _empty_ring():
    trace.clear()
    yield
    trace.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(spans):
    """{name: (parent's name, root's name)} of ``spans``."""
    by_id = {s.id: s.name for s in spans}
    return {s.name: (by_id.get(s.parent), by_id[s.root]) for s in spans}


def test_off_returns_the_shared_noop_and_records_nothing():
    assert not torch.autograd._profiler_enabled()
    first = trace.span("test.a", device=True, k=1)
    assert first is trace.span("test.b") is trace._OFF
    with first as inside:
        assert inside is None
    assert trace.records() == []


def test_on_spans_form_a_tree_of_cpu_ops_on_the_profilers_clock(tmp_path):
    names = ["test.root", "test.child", "test.grandchild", "test.sibling",
             "test.second"]
    with _cpu_profile() as prof:
        with trace.span("test.root", k=3):
            with trace.span("test.child"):
                with trace.span("test.grandchild"):
                    torch.ones(8).sum()
            with trace.span("test.sibling"):
                torch.ones(8).sum()
        with trace.span("test.second"):
            torch.ones(8).sum()
    spans = trace.records()
    assert sorted(s.name for s in spans) == sorted(names)
    assert _tree(spans) == {
        "test.root": (None, "test.root"),
        "test.child": ("test.root", "test.root"),
        "test.grandchild": ("test.child", "test.root"),
        "test.sibling": ("test.root", "test.root"),
        "test.second": (None, "test.second"),
    }
    root = trace.records("test.root")[0]
    assert root.attrs == {"k": 3} and root.device_ms is None
    assert all(s.end_ns >= s.start_ns for s in spans)
    assert not set(names) & HARNESS_SPANS

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    cats = {}
    for e in events:
        if e.get("name") in names:
            cats.setdefault(e["name"], set()).add(e.get("cat"))
    assert cats == {n: {"cpu_op"} for n in names}
    for e in prof.events():
        if e.name in names:
            assert not e.is_user_annotation

    start_ns = prof.profiler.kineto_results.trace_start_ns()
    first = {}
    for e in prof.events():
        if e.name in names:
            first.setdefault(e.name, start_ns + e.time_range.start * 1e3)
    for s in sorted(spans, key=lambda s: s.start_ns)[1:]:
        assert abs(s.start_ns - first[s.name]) < 200e3, s


def test_cut_tiles_records_the_serving_frames_useful_share():
    image = torch.zeros(1080, 1920, 3)
    before = trace.counters()
    with _cpu_profile(), torch.inference_mode():
        tiles, n_tiles, padded = cut_tiles(image, 64, 8, 16)
    (cut,) = trace.records("tiled.cut")
    assert cut.attrs == {"tiles": 700, "slots": 704,
                         "slot_px": 704 * 64 * 64, "lr_px": 1080 * 1920}
    assert (n_tiles, len(tiles), padded) == (700, 704, (1080, 1920))
    assert round(100 * cut.attrs["lr_px"] / cut.attrs["slot_px"], 2) == 71.91
    after = trace.counters()
    for key, n in (("tiles", 700), ("tile_slots", 704),
                   ("tile_slot_px", 704 * 4096), ("tile_lr_px", 2073600)):
        assert after[key] - before.get(key, 0) == n


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    gen = ESRGANGenerator(num_rrdb_blocks=1,
                          generator=torch.Generator().manual_seed(3))
    path = str(tmp_path_factory.mktemp("trace_ckpt") / "esrgan-gan-best.pth")
    save_checkpoint(path, 1, "gan", gen.state_dict())
    return path


def _service(checkpoint):
    return server.CheckpointUpscaleService(
        model="esrgan", checkpoint=checkpoint, tile=16, tile_batch=2,
        device="cpu")


def test_service_request_spans(checkpoint):
    service = _service(checkpoint)
    frame = np.random.default_rng(2).integers(0, 256, (20, 27, 3), np.uint8)
    with _cpu_profile():
        out = service._guarded_upscale(frame, 4)
    assert out.shape == (80, 108, 3)
    spans = trace.records()
    tree = _tree(spans)
    assert tree["serve.request"] == (None, "serve.request")
    for child in ("serve.upload", "serve.tiles", "serve.copy_out"):
        assert tree[child] == ("serve.request", "serve.request")
    for child in ("tiled.cut", "tiled.batch", "tiled.blend"):
        assert tree[child] == ("serve.tiles", "serve.request")
    (cut,) = trace.records("tiled.cut")
    assert len(trace.records("tiled.batch")) == cut.attrs["slots"] // 2
    (request,) = trace.records("serve.request")
    assert request.attrs == {"lr_h": 20, "lr_w": 27}
    assert all(s.device_ms is None for s in spans)  # no device time here
    assert not {s.name for s in spans} & HARNESS_SPANS


def test_service_times_the_lock_wait_apart_from_the_device_call(checkpoint):
    service = _service(checkpoint)
    frame = np.zeros((20, 20, 3), np.uint8)
    worker = threading.Thread(target=service._guarded_upscale,
                              args=(frame, 4))
    with service._lock:
        worker.start()
        time.sleep(0.3)
    worker.join(timeout=60)
    assert not worker.is_alive()
    m = service.metrics()
    assert m["lock_wait_ms_mean"] >= 250
    assert m["device_ms_mean"] < m["lock_wait_ms_mean"]
    assert m["tiles"] >= 4 and m["tile_slots"] >= m["tiles"]
    assert 0 < m["tile_useful_pct"] <= 100


def _trainer():
    args = Namespace(
        batch_size=2, disable_amp=True, epochs=1, pretrain_epochs=1,
        gan_checkpoint=None, psnr_checkpoint=None, seed=0,
        skip_image_save=True, model="srgan", num_residual=1, vgg_convs=2,
        metrics_file=None, vgg_weights=None)
    return SRGANTrainer(args, types.SimpleNamespace(crop_size=32), None, 1,
                        1, device=torch.device("cpu"), logger=None)


@pytest.mark.parametrize("phase", ["psnr", "gan"])
def test_trainer_call_is_one_span_with_k_and_phase(phase):
    trainer = _trainer()
    rng = np.random.default_rng(1)
    crops = torch.from_numpy(rng.integers(0, 256, (2, 2, 32, 32, 3),
                                          np.uint8))
    flips = torch.from_numpy(rng.random((2, 2, 2)) < 0.5)
    with _cpu_profile():
        if phase == "psnr":
            trainer.pretrain_step_multi(crops, flips)
        else:
            trainer.gan_step_multi(crops, flips, 1e-4, 1e-4)
    (call,) = trace.records("train.call")
    assert call.attrs == {"phase": phase, "k": 2}
    assert call.parent is None and call.device_ms is None
    # the CPU runs K eager steps: no capture, no replay
    assert {s.name for s in trace.records()} == {"train.call"}


def test_ring_overflow_is_counted_not_raised(monkeypatch):
    monkeypatch.setattr(trace, "_ring", deque(maxlen=4))
    assert trace.dropped() == 0
    with _cpu_profile():
        for i in range(7):
            with trace.span("test.ring", i=i):
                pass
    kept = trace.records("test.ring")
    assert [s.attrs["i"] for s in kept] == [3, 4, 5, 6]
    assert trace.dropped() == 3
    trace.clear()
    assert trace.dropped() == 0 and trace.records() == []


def test_counts_add_up_across_threads():
    before = trace.counters().get("test.threads", 0)

    def add():
        for _ in range(2000):
            trace.count("test.threads")

    workers = [threading.Thread(target=add) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert trace.counters()["test.threads"] - before == 16000


def test_trace_cost_reports_each_host_cost_and_leaves_no_record():
    out = trace_cost.host_costs(200)
    for key in ("span_off_us", "span_off_attrs_us", "count_us",
                "span_on_us"):
        assert out[key] > 0
    assert trace.records() == []
