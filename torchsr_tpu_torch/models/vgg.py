"""VGG19 feature extractor for the perceptual loss, on NHWC tensors.

The PyTorch counterpart of ``torchsr_tpu/models/vgg.py``: torchvision's
VGG19 ``features[:36]`` (every layer through relu5_4, without the last
max-pool): blocks of [2, 2, 4, 4, 4] 3x3 convs with ReLU, 2x2/2
max-pools between them, widths [64, 128, 256, 512, 512].  The input is
raw [0, 1] pixels with no ImageNet normalization, the reference's
quirk, kept for parity.

The module is ``features``, an ``nn.Sequential`` with torchvision's
layer indices, so a torchvision ``vgg19-dcbb9e9d.pth`` state_dict loads
as it is (``load_vgg19_state_dict``).  Without such a file the kernels
are He-normal and the biases torch's default, drawn from a caller's
``torch.Generator``: random features, which the trainer warns about.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from torchsr_tpu_torch.models.layers import Conv

# Channel widths per conv, "M" = 2x2/2 max-pool; through relu5_4.
VGG19_CFG_36 = (
    64, 64, "M",
    128, 128, "M",
    256, 256, 256, 256, "M",
    512, 512, 512, 512, "M",
    512, 512, 512, 512,
)


class MaxPool(nn.Module):
    """2x2/2 max-pool on NHWC tensors."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2)
        return y.permute(0, 2, 3, 1)


class VGG19Features(nn.Module):
    """VGG19 trunk through relu5_4; returns the final NHWC feature map in
    ``compute_dtype``.  ``max_convs`` keeps only the first N convs
    (``--vgg-convs``, for small tests); None keeps all 16."""

    def __init__(
        self,
        max_convs: int | None = None,
        *,
        compute_dtype: torch.dtype | None = None,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        layers: list = []
        in_ch, n_convs = 3, 0
        for item in VGG19_CFG_36:
            if max_convs is not None and n_convs >= max_convs:
                break
            if item == "M":
                layers.append(MaxPool())
                continue
            conv = Conv(in_ch, item, kernel_std=math.sqrt(2.0 / (9 * in_ch)),
                        device=device, dtype=dtype)
            conv.reset_parameters(generator)
            layers += [conv, nn.ReLU()]
            in_ch, n_convs = item, n_convs + 1
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.features(x.to(self.compute_dtype or torch.float32))


def load_vgg19_state_dict(module: VGG19Features, state_dict: dict) -> None:
    """Load torchvision VGG19 weights (``features.{i}.weight/bias``, or
    the same keys without the ``features.`` prefix) into ``module``,
    keeping the convs a truncated trunk uses; raises on a missing or
    mis-shaped one."""
    if not any(str(k).startswith("features.") for k in state_dict):
        state_dict = {f"features.{k}": v for k, v in state_dict.items()}
    wanted = module.state_dict()
    missing = sorted(set(wanted) - set(state_dict))
    if missing:
        raise ValueError(f"VGG19 weights lack {missing[:4]}")
    module.load_state_dict({k: state_dict[k] for k in wanted})
