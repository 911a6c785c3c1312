"""VGG19's convolutional trunk through relu5_4 (torchvision ``vgg19``
``features[:36]``: blocks of 2, 2, 4, 4, 4 3x3 convs with ReLU and 2x2
max-pools between them, widths 64, 128, 256, 512, 512), for the
perceptual loss.  Its input is the [0, 1] image without ImageNet
normalization, as the recipe the port follows feeds it.  Keys are
torchvision's (``features.{i}``).  The weights are seeded random
features (He-normal kernels; biases with the variance of PyTorch's
default draw): no pretrained VGG19 is available to the benchmark, and
the work is the same.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference import ops


def _layout(cfg: dict, max_convs: int | None = None) -> list:
    """("conv", index, c_in, c_out) or ("pool",) in order."""
    out, idx, c_in, n = [], 0, 3, 0
    for item in cfg["vgg"]["layers"]:
        if max_convs is not None and n >= max_convs:
            break
        if item == "M":
            out.append(("pool",))
            idx += 1
            continue
        out.append(("conv", idx, c_in, item))
        idx += 2
        c_in, n = item, n + 1
    return out


def specs(cfg: dict, max_convs: int | None = None) -> list:
    out = []
    for layer in _layout(cfg, max_convs):
        if layer[0] == "conv":
            _, i, c_in, c_out = layer
            fan_in = 9 * c_in
            out.append((f"features.{i}.weight", (c_out, c_in, 3, 3),
                        math.sqrt(2.0 / fan_in), 0.0))
            out.append((f"features.{i}.bias", (c_out,),
                        1.0 / math.sqrt(3.0 * fan_in), 0.0))
    return out


def features(w: dict, x: torch.Tensor, cfg: dict, prec: str = "f32",
             max_convs: int | None = None) -> torch.Tensor:
    for layer in _layout(cfg, max_convs):
        if layer[0] == "pool":
            x = F.max_pool2d(x, 2, 2)
        else:
            i = layer[1]
            x = torch.relu(ops.conv(x, w[f"features.{i}.weight"],
                                    w[f"features.{i}.bias"], prec))
    return x
