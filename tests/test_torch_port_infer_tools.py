"""The port's inference tools (``torchsr_tpu_torch/tools/``
``bench_inference``, ``bench_batching``, ``bench_serve_http``,
``profile_infer``) run end to end on the CPU at a tiny size (one block,
16 px tiles, small frames): each returns its rows with finite positive
times and names the device.  The numbers are the CPU's, not the card's;
on the card they run at their defaults (``PERF.md`` §5)."""

import math

import pytest
import torch

from torchsr_tpu_torch.tools import (
    bench_batching,
    bench_inference,
    bench_serve_http,
    profile_infer,
)

TINY = ["--device", "cpu", "--blocks", "1"]


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def one_thread(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _positive(*values) -> bool:
    return all(math.isfinite(v) and v > 0 for v in values)


@pytest.mark.parametrize("model", ["esrgan", "srgan"])
def test_bench_inference(model):
    row = bench_inference.main([*TINY, "--model", model, "--frame-hw",
                                "40,52", "--tile", "16", "--overlap", "4",
                                "--tile-batch", "2", "--frames", "1"])
    assert _positive(row["ms_per_frame"], row["input_mp_per_s"])
    assert row["output_mp_per_s"] == pytest.approx(
        16 * row["input_mp_per_s"])
    assert row["device"] == "cpu"


def test_bench_batching():
    row = bench_batching.main([*TINY, "--model", "srgan", "--tile", "16",
                               "--tile-batch", "4", "--clients", "4",
                               "--requests", "2", "--wait-ms", "50"])
    assert _positive(row["frames_per_s_off"], row["frames_per_s_on"])
    assert row["tiles_per_forward"] > 1  # the batcher coalesced


def test_bench_serve_http():
    rows = bench_serve_http.main([*TINY, "--frame-hw", "24,30", "--tile",
                                  "16", "--tile-batch", "2", "--overlap",
                                  "4", "--frames", "1", "--backends",
                                  "checkpoint,native"])
    assert [r["backend"] for r in rows] == ["checkpoint", "native"]
    for r in rows:
        assert _positive(r["device_ms"], r["direct_ms"],
                         r["http"]["png"]["ms"], r["http"]["jpeg"]["ms"])
        assert r["compute_dtype"] == "float32"  # the CPU's


@pytest.mark.parametrize("model, extra", [
    ("esrgan", []), ("srgan", ["--sweep", "--tiles", "16", "--batches",
                               "2"])])
def test_profile_infer(model, extra):
    out = profile_infer.main([*TINY, "--model", model, "--tile", "16",
                              "--overlap", "4", "--tile-batch", "2",
                              "--frame-hw", "24,30", "--reps", "1",
                              "--frames", "1", *extra])
    if extra:
        assert [r["tile"] for r in out["sweep"]] == [16]
        assert _positive(out["sweep"][0]["wall_ms"])
        return
    sections = {"conv1", "trunk", "conv2_skip", "upsample", "head",
                "head_direct", "head_subpixel"}
    assert {"gen_fwd_graph", "gen_fwd_eager"} | sections == set(
        out["components"])
    assert all(_positive(r["wall_ms"]) for r in out["components"].values())
    assert set(out["frame_probes"]) == {"frame", "machinery"}
