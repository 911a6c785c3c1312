"""The plain reference against the port on the CPU, at small sizes and
full widths, in f32: the same weights give the same results."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import generate, weights
from port_bench.reference import esrgan, pairs, srgan, tiling, training, vgg

CONFIGS = Path(weights.__file__).resolve().parent / "configs"


def config(name: str, **changes) -> dict:
    return {**json.loads((CONFIGS / f"{name}.json").read_text()), **changes}


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def test_esrgan_generator():
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator

    cfg = config("esrgan", num_rrdb=2)
    w = weights.make(esrgan.generator_specs(cfg), 3, "generator", "cpu")
    port = ESRGANGenerator(num_rrdb_blocks=2)
    weights.load_into(port, w)
    x = torch.rand(2, 3, 9, 7)
    with torch.no_grad():
        got = nchw(port(nhwc(x)))
        ref = esrgan.generator(w, x, cfg)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train", [True, False])
def test_srgan_generator(train):
    from torchsr_tpu_torch.models.srgan import SRGANGenerator

    cfg = config("srgan", num_residual=2)
    w = weights.make(srgan.generator_specs(cfg), 4, "generator", "cpu")
    port = SRGANGenerator(num_residual=2).train(train)
    weights.load_into(port, w)
    stats = None
    if not train:
        gen = torch.Generator().manual_seed(0)
        stats = {}
        for name, buf in port.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.copy_(torch.rand(buf.shape, generator=gen) + (
                    0.5 if name.endswith("var") else -0.5))
                stats[name] = buf.clone()
    x = torch.rand(3, 3, 8, 6)
    with torch.no_grad():
        got = nchw(port(nhwc(x)))
        ref = srgan.generator(w, x, cfg, stats=stats)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name, size", [("esrgan", 32), ("srgan", 16)])
def test_discriminator(name, size):
    from torchsr_tpu_torch.models.esrgan import ESRGANDiscriminator
    from torchsr_tpu_torch.models.srgan import SRGANDiscriminator

    cfg = config(name)
    net = {"esrgan": esrgan, "srgan": srgan}[name]
    cls = {"esrgan": ESRGANDiscriminator, "srgan": SRGANDiscriminator}[name]
    w = weights.make(net.discriminator_specs(cfg, size), 5, "d", "cpu")
    port = cls(image_size=size).train()
    weights.load_into(port, w)
    x = torch.rand(4, 3, size, size)
    with torch.no_grad():
        torch.testing.assert_close(port(nhwc(x)), net.discriminator(w, x, cfg),
                                   rtol=1e-4, atol=1e-5)


def test_vgg19():
    from torchsr_tpu_torch.models.vgg import VGG19Features

    cfg = config("esrgan")
    w = weights.make(vgg.specs(cfg), 6, "vgg", "cpu")
    port = VGG19Features()
    weights.load_into(port, w)
    x = torch.rand(2, 3, 32, 32)
    with torch.no_grad():
        torch.testing.assert_close(nchw(port(nhwc(x))),
                                   vgg.features(w, x, cfg),
                                   rtol=1e-4, atol=1e-4)


def test_pair_synthesis():
    from torchsr_tpu_torch.data.preprocess import synthesize_pair

    mix = {"batches_per_epoch": 1, "batch": 6, "crop": 48,
           "mean": [0.15, 0.85], "contrast": [0.1, 1.0]}
    crops, flips = (torch.from_numpy(a) for a in generate.Crops(mix, 9).batch(0))
    lr_p, hr_p = synthesize_pair(crops, flips, 4)
    lr_r, hr_r = pairs.synthesize(crops, flips, 4)
    assert torch.equal(nchw(hr_p), hr_r) or (nchw(hr_p) - hr_r).abs().max() < 1e-6
    diff = (nchw(lr_p) - lr_r).abs()
    assert diff.max() <= 1 / 255 + 1e-6     # a rounding tie at most
    assert (diff > 1e-6).float().mean() < 1e-3


def test_pair_weights_are_pils_antialiased_bicubic():
    m = pairs.weights(96, 24)
    assert m.shape == (24, 96)
    np.testing.assert_allclose(m.sum(1), 1.0, atol=1e-12)
    assert (np.count_nonzero(m, axis=1) <= 16).all()


@pytest.mark.parametrize("hw, tile, overlap", [((37, 45), 16, 4),
                                               ((12, 30), 16, 4),
                                               ((64, 64), 32, 8)])
def test_tiled_upscale_cut_and_blend(hw, tile, overlap):
    from torchsr_tpu_torch.infer.tiled import tiled_upscale

    gen = torch.Generator().manual_seed(1)
    frame = torch.randint(0, 256, (*hw, 3), dtype=torch.uint8, generator=gen)
    kernel = torch.rand(3, 3, 3, 3, generator=gen) / 9

    def net(x):  # any per-tile function of the tile: a conv, then x4
        y = torch.nn.functional.conv2d(x, kernel, padding=1)
        return y.repeat_interleave(4, 2).repeat_interleave(4, 3)

    ref = tiling.upscale(frame, net, scale=4, tile=tile, overlap=overlap,
                         batch=3)
    out = tiled_upscale(lambda t: nhwc(net(nchw(t))),
                        frame.float() / 255.0, scale=4, tile=tile,
                        overlap=overlap, tile_batch=3)
    got = (out.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    assert got.shape == ref.shape
    assert (got.int() - ref.int()).abs().max() <= 1
    assert (got != ref).float().mean() < 1e-3


def test_adam_matches_torch():
    gen = torch.Generator().manual_seed(2)
    p = {"a": torch.randn(5, 4, generator=gen)}
    q = p["a"].clone().requires_grad_(True)
    mine = training.Adam(p, 1e-3, (0.9, 0.999), 1e-8)
    theirs = torch.optim.Adam([q], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(3):
        g = torch.randn(5, 4, generator=gen)
        mine.step({"a": g})
        q.grad = g.clone()
        theirs.step()
    torch.testing.assert_close(p["a"], q.detach(), rtol=1e-6, atol=1e-7)


def test_losses():
    x = torch.randn(7)
    t = torch.ones(7)
    torch.testing.assert_close(
        training.bce_logits(x, 1.0),
        torch.nn.functional.binary_cross_entropy_with_logits(x, t))
    p = torch.sigmoid(x)
    torch.testing.assert_close(training.bce_probs(p, 0.0),
                               torch.nn.functional.binary_cross_entropy(
                                   p, torch.zeros(7)))
