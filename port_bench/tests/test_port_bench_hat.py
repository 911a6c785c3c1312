"""HAT's FLOP and byte arithmetic (``flops_hat.py``) against hand counts
and the multiply-adds its reference runs; its serving cell and the
four-card GAN cell run end to end on the CPU at a small size; its
reference's rank emulation and the faults that its control plants."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from port_bench import compare, control_ddp, flops, flops_hat, harness, run
from port_bench.reference import ddp, hat

CONFIGS = Path(flops.__file__).resolve().parent / "configs"
HAT = json.loads((CONFIGS / "hat.json").read_text())
TINY_HAT = {"embed_dim": 24, "depths": [2, 2], "num_heads": [2, 2],
            "window_size": 4, "squeeze_factor": 6}
TINY = {
    "hat.serve.frame-1080p": {
        "config": TINY_HAT,
        "traffic": {"deck": [{"lr_hw": [20, 24], "count": 2},
                             {"lr_hw": [18, 22], "count": 1}]},
        "cell": {"service": {"tile": 16, "overlap": 4, "tile_batch": 4,
                             "reference_batch": 8}}},
    "esrgan.train.gan-b64-ddp4": {
        "config": {"num_rrdb": 1, "vgg_convs": 2},
        "traffic": {"batch": 2, "crop": 32, "batches_per_epoch": 6}},
}


def tiny_run(name: str, seed: int = 7, seconds: float = 0.5) -> dict:
    r = harness.Run.of(name, seed=seed, seconds=seconds, trace=False,
                       device=torch.device("cpu"),
                       t_start=time.perf_counter(),
                       hooks={"overrides": TINY[name]})
    return run.execute(r)


def test_srx4_flops_per_lr_pixel():
    # per token: HAB 1,091,520 MACs x 36, OCAB 933,120 x 6 ... / 2
    blocks = flops_hat.block_macs_per_token(HAT)
    c = 180
    assert blocks["hab"] == 4 * c * c + 2 * c * 360 + 2 * 9 * c * 60 \
        + 2 * 256 * c
    assert blocks["ocab"] == 4 * c * c + 2 * c * 360 + 2 * 576 * c
    assert flops_hat.generator_flops_per_lr_pixel(HAT) == pytest.approx(
        50.72e6, rel=1e-3)


@pytest.mark.parametrize("overlap, keys, flop", [(False, 256, 96.6e9),
                                                 (True, 576, 217.4e9)])
def test_attention_bound_at_the_serving_shape(overlap, keys, flop):
    f, b = flops_hat.attn_cost(8, 256, 256, 180, keys)
    assert f == pytest.approx(flop, rel=1e-3)
    assert b == pytest.approx(755e6, rel=1e-3)
    svc = {"tile": 256, "tile_batch": 8}
    assert flops_hat.attn_bound_ms(HAT, svc, overlap) == pytest.approx(
        0.2254, rel=1e-3)          # bytes bound, both


def test_reference_macs_match_the_count():
    """The reference's products at a small map, counted by a hook on
    ``ops.operand``'s partners: conv and dense multiply-adds and both
    attention products, against ``flops_hat``'s count of the same
    widths (no pad: the map is a whole number of windows)."""
    cfg = {**HAT, **TINY_HAT, "depths": [1], "num_heads": [2]}
    from port_bench import weights

    w = weights.make(hat.generator_specs(cfg), 3, "generator", "cpu")
    counted = {"macs": 0}
    real_conv, real_dense, real_mm = hat.ops.conv, hat.ops.dense, hat._mm

    def conv(x, wt, b, prec="f32", stride=1):
        y = real_conv(x, wt, b, prec, stride)
        if wt.shape[-1] > 1:       # the pooled gate's 1x1 convs: left out
            counted["macs"] += y.numel() // y.shape[0] * wt[0].numel() \
                * x.shape[0]
        return y

    def dense(x, wt, b, prec="f32"):
        counted["macs"] += x.numel() // x.shape[-1] * wt.numel()
        return real_dense(x, wt, b, prec)

    def mm(a, b, prec):
        counted["macs"] += a.numel() * b.shape[-1]
        return real_mm(a, b, prec)

    hat.ops.conv, hat.ops.dense, hat._mm = conv, dense, mm
    try:
        with torch.no_grad():
            hat.generator(w, torch.rand(1, 3, 8, 8), cfg)
    finally:
        hat.ops.conv, hat.ops.dense, hat._mm = real_conv, real_dense, real_mm
    want = flops_hat.generator_macs_per_lr_pixel({**cfg, "scale": 4}) * 64
    assert counted["macs"] == want


def test_hat_serve_sound():
    line = tiny_run("hat.serve.frame-1080p")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"serve_output_mp_per_s",
                                    "serve_request_p95_ms",
                                    "device_peak_gib", "setup_s"}


def test_ddp4_sound_on_four_cpu_processes():
    """The data-parallel cell with four gloo ranks: the ranks' mean
    losses and rank 0's gradients against the reference on the global
    batch."""
    line = tiny_run("esrgan.train.gan-b64-ddp4", seconds=1.0)
    assert line["correct"], line["checks"]
    assert line["device"]["count"] == 4
    assert set(line["metrics"]) == {"train_crops_per_s", "device_peak_gib",
                                    "setup_s"}


def test_each_pair_of_config_and_traffic_once():
    cells = harness.benchmark()["workloads"]
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)


def test_ddp4_traffic_is_the_gan_cells_a_rank():
    """The four-card cell has its own traffic file (a pair of
    configuration and traffic is one cell), with the one-card GAN cell's
    numbers: each rank steps on what one card does there."""
    mine = harness.load_json("traffic", "gan-b64-ddp4.json")
    one = harness.load_json("traffic", "gan-b64.json")
    assert set(mine) == set(one)
    assert {k: v for k, v in mine.items() if k != "what"} \
        == {k: v for k, v in one.items() if k != "what"}


def _tiny_ddp_run(seed: int = 3000000017):
    return harness.Run.of("esrgan.train.gan-b64-ddp4", seed=seed,
                          seconds=0.0, trace=False,
                          device=torch.device("cpu"), t_start=0.0,
                          hooks={"overrides": TINY[
                              "esrgan.train.gan-b64-ddp4"]})


def test_ddp_rank_emulation_is_the_global_step():
    """``run_ranks`` with the exchange against the step on the global
    batch: the discriminator's first loss and gradients come before any
    update, so they differ only by f32 sums in another order (each
    rank's rows apart, then the mean of four)."""
    r = _tiny_ddp_run()
    cfg, mix = r.config, r.traffic
    from port_bench.drivers.train import model_weights
    from port_bench.drivers.train_ddp import global_batch

    w = model_weights(cfg, mix, r.seed, "cpu", cfg.get("vgg_convs"))
    batches = [tuple(torch.from_numpy(a) for a in global_batch(mix, r.seed,
                                                                4, j))
               for j in range(2)]
    base = ddp.run_steps(cfg, w, batches, lr=mix["lr"], chunk=mix["batch"],
                         vgg_convs=cfg.get("vgg_convs"))
    got = ddp.run_ranks(cfg, w, batches, lr=mix["lr"], world=4,
                        vgg_convs=cfg.get("vgg_convs"))
    assert got["losses"][0][0] == pytest.approx(base["losses"][0][0],
                                                rel=1e-6)
    assert compare.training(got, base)["grad1_gap_median_d"] < 1e-4


@pytest.mark.parametrize("reading, fails", [("ranks", False),
                                            ("half_batch", True),
                                            ("no_exchange", True)])
def test_ddp_control_readings(reading, fails):
    """The control's emulation reads sound and each planted fault fails
    a limit of the cell (at this small size; the cell's own readings on
    the card are in PERF.md)."""
    (row,) = control_ddp.readings(_tiny_ddp_run(), 3000000017, [reading])
    assert bool(row["fails"]) == fails, row
