"""ESRGAN (Wang et al., arXiv:1809.00219): the RRDBNet generator and the
VGG-style discriminator, plain f32 PyTorch on NCHW tensors.

Generator (xinntao/ESRGAN ``RRDBNet_arch.py`` defaults: nf 64, gc 32,
23 RRDBs): conv3(3 -> nf); RRDBs of three residual dense blocks, each
five 3x3 convs over the concatenation of the block input and every
earlier output (LeakyReLU 0.2 after the first four), ``x + 0.2 *
conv5``, and ``x + 0.2 * RDB3(RDB2(RDB1(x)))`` around them; the trunk
conv and the long skip; two stages of nearest x2 upsampling, conv3 and
LeakyReLU; conv3, LeakyReLU, conv3(nf -> 3).  Departures: the keys are
those of the PyTorch re-implementation the port loads (``conv1``,
``blocks.{i}.RDB{j}.conv{1..4}.0``, ``conv5``, ``conv2``,
``upsample{k}``, ``conv3.0``, ``conv4``), not ``RRDBNet_arch.py``'s;
the computation is the same.

Discriminator (the paper's VGG-style network for 128x128 crops): ten
3x3 conv stages of (64, 1), (64, 2), (128, 1), (128, 2), (256, 1),
(256, 2), (512, 1), (512, 2), (512, 1), (512, 2) channels and strides,
BatchNorm on all but the first (no conv bias where BatchNorm follows),
LeakyReLU 0.2, then Linear(512 * (S/32)^2 -> 100), LeakyReLU,
Linear(100 -> 1); raw logits.  BatchNorm normalizes with the batch's
statistics (the discriminator only runs in training mode).

Seeded initialization (``generator_specs``, ``discriminator_specs``;
the benchmark draws the values): the dense blocks' kernels
kaiming-normal x 0.1 and their biases 0 (``RRDBNet_arch.py``'s
``initialize_weights(..., 0.1)``); the generator's other kernels with
the variance of PyTorch's default uniform draw, 1 / (3 fan_in), as a
normal draw, but the last one at half that standard deviation, and its
biases 0 but the last conv's, 0.5: so that a random generator's output
spreads over [0, 1] instead of clamping (a clamped pixel would hide the
generator from the check).  The discriminator's kernels and biases at
the default variance, BatchNorm scale 1, shift 0.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference import ops

CIN = (64, 96, 128, 160, 192)


def _default(name: str, shape: tuple, fan_in: int, bias: bool = True):
    std = 1.0 / math.sqrt(3.0 * fan_in)
    out = [(f"{name}.weight", shape, std, 0.0)]
    if bias:
        out.append((f"{name}.bias", (shape[0],), std, 0.0))
    return out


def _conv(name: str, shape: tuple, std: float, bias: float = 0.0):
    return [(f"{name}.weight", shape, std, 0.0),
            (f"{name}.bias", (shape[0],), 0.0, bias)]


def generator_specs(cfg: dict) -> list:
    """(name, shape, std, mean) of every generator parameter."""
    nf, gc = cfg["nf"], cfg["gc"]
    cin = [nf + i * gc for i in range(cfg["convs_per_rdb"])]
    cout = [gc] * (cfg["convs_per_rdb"] - 1) + [nf]
    std = 1.0 / math.sqrt(3.0 * 9 * nf)
    specs = _conv("conv1", (nf, 3, 3, 3), 1.0 / math.sqrt(3.0 * 27))
    for i in range(cfg["num_rrdb"]):
        for j in range(1, cfg["rdbs_per_rrdb"] + 1):
            for k, (ci, co) in enumerate(zip(cin, cout)):
                last = k == len(cin) - 1
                name = (f"blocks.{i}.RDB{j}.conv{k + 1}"
                        + ("" if last else ".0"))
                specs += _conv(name, (co, ci, 3, 3),
                               0.1 * math.sqrt(2.0 / (9 * ci)))
    specs += _conv("conv2", (nf, nf, 3, 3), std)
    for k in range(int(math.log2(cfg["scale"]))):
        specs += _conv(f"upsample{k + 1}", (nf, nf, 3, 3), std)
    specs += _conv("conv3.0", (nf, nf, 3, 3), std)
    return specs + _conv("conv4", (3, nf, 3, 3), std / 2, bias=0.5)


def _rdb(w: dict, name: str, x: torch.Tensor, n_convs: int, res: float,
         slope: float, prec: str) -> torch.Tensor:
    feats = [x]
    for k in range(n_convs):
        last = k == n_convs - 1
        key = f"{name}.conv{k + 1}" + ("" if last else ".0")
        y = ops.conv(torch.cat(feats, 1), w[f"{key}.weight"],
                     w[f"{key}.bias"], prec)
        if last:
            return x + res * y
        feats.append(ops.lrelu(y, slope))
    raise AssertionError("unreachable")


def generator(w: dict, x: torch.Tensor, cfg: dict,
              prec: str = "f32") -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> (B, 3, sH, sW)."""
    res, slope = cfg["residual_scale"], cfg["lrelu_slope"]
    fea = ops.conv(x, w["conv1.weight"], w["conv1.bias"], prec)
    h = fea
    for i in range(cfg["num_rrdb"]):
        r = h
        for j in range(1, cfg["rdbs_per_rrdb"] + 1):
            r = _rdb(w, f"blocks.{i}.RDB{j}", r, cfg["convs_per_rdb"], res,
                     slope, prec)
        h = h + res * r
    h = fea + ops.conv(h, w["conv2.weight"], w["conv2.bias"], prec)
    for k in range(int(math.log2(cfg["scale"]))):
        h = ops.lrelu(ops.conv(ops.nearest2(h), w[f"upsample{k + 1}.weight"],
                               w[f"upsample{k + 1}.bias"], prec), slope)
    h = ops.lrelu(ops.conv(h, w["conv3.0.weight"], w["conv3.0.bias"], prec),
                  slope)
    return ops.conv(h, w["conv4.weight"], w["conv4.bias"], prec)


def _disc_layout(stages) -> list:
    """(conv index, bn index or None, c_in, c_out, stride) per stage, at
    the ``features.{i}`` indices of conv, BatchNorm, activation."""
    out, idx, c_in = [], 0, 3
    for c_out, stride, use_bn in stages:
        conv_i = idx
        bn_i = idx + 1 if use_bn else None
        idx += 3 if use_bn else 2
        out.append((conv_i, bn_i, c_in, c_out, stride))
        c_in = c_out
    return out


def discriminator_specs(cfg: dict, image_size: int) -> list:
    d = cfg["disc"]
    specs = []
    for conv_i, bn_i, c_in, c_out, _stride in _disc_layout(d["stages"]):
        specs += _default(f"features.{conv_i}", (c_out, c_in, 3, 3),
                          9 * c_in, bias=bn_i is None)
        if bn_i is not None:
            specs.append((f"features.{bn_i}.weight", (c_out,), 0.0, 1.0))
            specs.append((f"features.{bn_i}.bias", (c_out,), 0.0, 0.0))
    reduce = 2 ** sum(1 for s in d["stages"] if s[1] == 2)
    flat = d["stages"][-1][0] * (image_size // reduce) ** 2
    specs += _default("classifier.0", (d["dense"], flat), flat)
    specs += _default("classifier.2", (1, d["dense"]), d["dense"])
    return specs


def discriminator_trunk(w: dict, x: torch.Tensor, stages, slope: float,
                        prec: str) -> torch.Tensor:
    for conv_i, bn_i, _ci, _co, stride in _disc_layout(stages):
        x = ops.conv(x, w[f"features.{conv_i}.weight"],
                     w.get(f"features.{conv_i}.bias"), prec, stride)
        if bn_i is not None:
            x = ops.batch_norm_train(x, w[f"features.{bn_i}.weight"],
                                     w[f"features.{bn_i}.bias"])
        x = ops.lrelu(x, slope)
    return x.flatten(1)


def discriminator(w: dict, x: torch.Tensor, cfg: dict,
                  prec: str = "f32") -> torch.Tensor:
    """(B, 3, S, S) -> (B, 1) logits."""
    d = cfg["disc"]
    h = discriminator_trunk(w, x, d["stages"], d["lrelu_slope"], prec)
    h = ops.lrelu(ops.dense(h, w["classifier.0.weight"],
                            w["classifier.0.bias"], prec), d["lrelu_slope"])
    return ops.dense(h, w["classifier.2.weight"], w["classifier.2.bias"], prec)
