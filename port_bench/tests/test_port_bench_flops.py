"""The FLOP and byte arithmetic against hand counts, the bounds the
port's kernel table gives, and the multiply-adds the reference nets
actually run."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from port_bench import flops
from port_bench.reference import esrgan, ops, srgan, vgg

CONFIGS = Path(flops.__file__).resolve().parent / "configs"


def config(name: str, **changes) -> dict:
    return {**json.loads((CONFIGS / f"{name}.json").read_text()), **changes}


def test_rdb_macs_per_pixel():
    # 9 * (64*32 + 96*32 + 128*32 + 160*32 + 192*64)
    assert flops.rdb_macs_per_pixel() == 239_616


@pytest.mark.parametrize("cost, shape, bound_ms", [
    (flops.rdb_fwd_cost, (16, 64, 64), 0.0318),
    (flops.rdb_bwd_cost, (64, 32, 32), 0.0635)])
def test_rdb_bounds(cost, shape, bound_ms):
    assert flops.bound_ms(*cost(*shape)) == pytest.approx(bound_ms, rel=2e-3)


def test_rdb_bounds_are_compute_bound():
    for cost, shape in ((flops.rdb_fwd_cost, (16, 64, 64)),
                        (flops.rdb_bwd_cost, (64, 32, 32))):
        f, b = cost(*shape)
        assert f / flops.PEAK_BF16_FLOPS > b / flops.PEAK_HBM_BYTES


def test_esrgan_generator_per_lr_pixel_hand_count():
    macs = (3 * 9 * 64 + 69 * 239_616 + 9 * 64 * 64
            + 9 * 64 * 64 * 4 + 9 * 64 * 64 * 16      # upsample stages
            + 9 * 64 * 64 * 16 + 9 * 64 * 3 * 16)     # HR conv, last conv
    assert macs == 17_926_848
    got = flops.generator_flops_per_lr_pixel(config("esrgan"))
    assert got == 2 * macs


def test_srgan_pretrain_flops_per_crop():
    # 2,218,176 multiply-adds an LR pixel, 24 x 24 LR pixels a 96 crop,
    # forward, input and weight gradients (the first layer's input
    # gradient is not needed)
    per_crop = flops.step_flops(config("srgan"), "pretrain", 1, 96)
    fwd = 2 * 2_218_176 * 576
    first = 2 * 81 * 3 * 64 * 576
    assert per_crop == 3 * fwd - first
    assert per_crop == pytest.approx(7.648e9, rel=1e-3)


def _counted_macs(run) -> int:
    """Multiply-adds of the convs and dense products ``run`` calls."""
    total = [0]
    conv, dense = ops.conv, ops.dense

    def count_conv(x, w, b, prec="f32", stride=1):
        y = conv(x, w, b, prec, stride)
        total[0] += y[0, 0].numel() * w[0].numel() * w.shape[0] * y.shape[0]
        return y

    def count_dense(x, w, b, prec="f32"):
        total[0] += x.shape[0] * w.numel()
        return dense(x, w, b, prec)

    ops.conv, ops.dense = count_conv, count_dense
    try:
        with torch.no_grad():
            run()
    finally:
        ops.conv, ops.dense = conv, dense
    return total[0]


def _weights(specs):
    return {n: torch.randn(s) * std + m for n, s, std, m in specs}


@pytest.mark.parametrize("name, depth", [("esrgan", {"num_rrdb": 1}),
                                         ("srgan", {"num_residual": 2})])
def test_generator_layers_match_the_reference(name, depth):
    cfg = config(name, **depth)
    net = {"esrgan": esrgan, "srgan": srgan}[name]
    w = _weights(net.generator_specs(cfg))
    x = torch.rand(2, 3, 6, 5)
    counted = _counted_macs(lambda: net.generator(w, x, cfg))
    assert counted == flops.macs(flops.generator_layers(cfg)) * 2 * 6 * 5


@pytest.mark.parametrize("name, size", [("esrgan", 64), ("srgan", 32)])
def test_discriminator_layers_match_the_reference(name, size):
    cfg = config(name)
    net = {"esrgan": esrgan, "srgan": srgan}[name]
    w = _weights(net.discriminator_specs(cfg, size))
    x = torch.rand(2, 3, size, size)
    counted = _counted_macs(lambda: net.discriminator(w, x, cfg))
    assert counted == 2 * flops.macs(flops.discriminator_layers(cfg, size))


def test_vgg_layers_match_the_reference():
    cfg = config("esrgan")
    w = _weights(vgg.specs(cfg))
    x = torch.rand(1, 3, 32, 32)
    counted = _counted_macs(lambda: vgg.features(w, x, cfg))
    assert counted == flops.macs(flops.vgg_layers(cfg, 32))
