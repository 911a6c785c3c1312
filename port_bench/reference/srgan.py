"""SRGAN (Ledig et al., arXiv:1609.04802, §3): the SRResNet generator and
the discriminator, plain f32 PyTorch on NCHW tensors.

Generator: conv9x9(3 -> 64) and PReLU; 16 residual blocks of conv3,
BatchNorm, PReLU, conv3, BatchNorm with an identity skip; conv3 and
BatchNorm with the long skip; two stages of conv3(64 -> 256), pixel
shuffle x2 and PReLU; conv9x9(64 -> 3), no output activation.
Departures: PReLU has one shared slope (``nn.PReLU()``), the convs
before a BatchNorm have no bias, and the keys are the PyTorch
re-implementation's (``conv1.{0,1}``, ``blocks.{i}.conv1/bn1/prelu/
conv2/bn2``, ``conv2.{0,1}``, ``conv_layers.{i}.conv/prelu``,
``conv3``).  BatchNorm uses the batch's statistics (``train=True``) or
the running ones.

Discriminator: eight 3x3 conv stages of (64, 1), (64, 2), (128, 1),
(128, 2), (256, 1), (256, 2), (512, 1), (512, 2), BatchNorm on all but
the first, LeakyReLU 0.2, Linear(512 * (S/16)^2 -> 1024), LeakyReLU,
Linear(1024 -> 1) and a sigmoid.

Seeded initialization (``generator_specs``): kernels and biases with
the variance of PyTorch's default uniform draw as a normal draw, PReLU
slopes 0.25, BatchNorm scale 1 and shift 0.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference import ops
from port_bench.reference.esrgan import (
    _default,
    discriminator_specs,
    discriminator_trunk,
)


def _bn(name: str, c: int) -> list:
    return [(f"{name}.weight", (c,), 0.0, 1.0), (f"{name}.bias", (c,), 0.0,
                                                  0.0)]


def generator_specs(cfg: dict) -> list:
    nf = cfg["nf"]
    specs = _default("conv1.0", (nf, 3, 9, 9), 243)
    specs.append(("conv1.1.weight", (1,), 0.0, 0.25))
    for i in range(cfg["num_residual"]):
        b = f"blocks.{i}"
        specs += _default(f"{b}.conv1", (nf, nf, 3, 3), 9 * nf, bias=False)
        specs += _bn(f"{b}.bn1", nf)
        specs.append((f"{b}.prelu.weight", (1,), 0.0, 0.25))
        specs += _default(f"{b}.conv2", (nf, nf, 3, 3), 9 * nf, bias=False)
        specs += _bn(f"{b}.bn2", nf)
    specs += _default("conv2.0", (nf, nf, 3, 3), 9 * nf, bias=False)
    specs += _bn("conv2.1", nf)
    for k in range(int(math.log2(cfg["scale"]))):
        specs += _default(f"conv_layers.{k}.conv", (4 * nf, nf, 3, 3), 9 * nf)
        specs.append((f"conv_layers.{k}.prelu.weight", (1,), 0.0, 0.25))
    specs += _default("conv3", (3, nf, 9, 9), 81 * nf)
    return specs


def _norm(w: dict, name: str, x: torch.Tensor, stats: dict | None):
    if stats is None:
        return ops.batch_norm_train(x, w[f"{name}.weight"], w[f"{name}.bias"])
    return ops.batch_norm_eval(x, w[f"{name}.weight"], w[f"{name}.bias"],
                               stats[f"{name}.running_mean"],
                               stats[f"{name}.running_var"])


def generator(w: dict, x: torch.Tensor, cfg: dict, prec: str = "f32",
              stats: dict | None = None) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 3, sH, sW); BatchNorm on the batch's
    statistics, or on ``stats``' running ones."""
    h0 = ops.prelu(ops.conv(x, w["conv1.0.weight"], w["conv1.0.bias"], prec),
                   w["conv1.1.weight"])
    h = h0
    for i in range(cfg["num_residual"]):
        b = f"blocks.{i}"
        r = ops.conv(h, w[f"{b}.conv1.weight"], None, prec)
        r = ops.prelu(_norm(w, f"{b}.bn1", r, stats), w[f"{b}.prelu.weight"])
        r = _norm(w, f"{b}.bn2", ops.conv(r, w[f"{b}.conv2.weight"], None,
                                           prec), stats)
        h = h + r
    h = h0 + _norm(w, "conv2.1", ops.conv(h, w["conv2.0.weight"], None, prec),
                   stats)
    for k in range(int(math.log2(cfg["scale"]))):
        c = f"conv_layers.{k}"
        h = ops.pixel_shuffle2(ops.conv(h, w[f"{c}.conv.weight"],
                                        w[f"{c}.conv.bias"], prec))
        h = ops.prelu(h, w[f"{c}.prelu.weight"])
    return ops.conv(h, w["conv3.weight"], w["conv3.bias"], prec)


def discriminator(w: dict, x: torch.Tensor, cfg: dict,
                  prec: str = "f32") -> torch.Tensor:
    """(B, 3, S, S) -> (B, 1) probabilities."""
    d = cfg["disc"]
    h = discriminator_trunk(w, x, d["stages"], d["lrelu_slope"], prec)
    h = ops.lrelu(ops.dense(h, w["classifier.0.weight"],
                            w["classifier.0.bias"], prec), d["lrelu_slope"])
    return torch.sigmoid(ops.dense(h, w["classifier.2.weight"],
                                   w["classifier.2.bias"], prec))


__all__ = ["generator_specs", "generator", "discriminator",
           "discriminator_specs"]
