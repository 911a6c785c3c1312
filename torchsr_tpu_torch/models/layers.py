"""Building blocks on NHWC tensors with torch-default initialization.

``Conv`` holds an OIHW ``weight`` and a ``bias`` (the ``nn.Conv2d`` key
names, so reference state_dicts load as they are) and runs on NHWC
activations: the conv sees an NCHW *view* of a contiguous NHWC tensor,
which is PyTorch's ``channels_last`` memory format, so no layout copy
is made.  Padding is ``k // 2`` on every side, as in torch.

Initialization draws from a caller's ``torch.Generator`` on the CPU
and copies to the parameter's device, so a seed gives the same weights
on every device and the global RNG is never touched.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """LeakyReLU(0.2), the ESRGAN activation."""
    return F.leaky_relu(x, negative_slope)


def _draw(param: torch.Tensor, fill, generator) -> None:
    """Fill ``param`` in place from ``fill(cpu_tensor, generator)``;
    skipped on the ``meta`` device, which holds no data."""
    if param.device.type == "meta":
        return
    cpu = torch.empty(param.shape, dtype=torch.float32)
    fill(cpu, generator)
    with torch.no_grad():
        param.copy_(cpu)


class Conv(nn.Module):
    """2-D convolution on NHWC tensors, torch default init.

    ``kernel_std`` replaces the default kaiming-uniform(a=sqrt 5) kernel
    init by a normal draw with that standard deviation (the ESRGAN
    residual dense blocks use kaiming-normal x 0.1).  The bias keeps
    torch's uniform(+-1/sqrt(fan_in)) either way.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        *,
        kernel_std: float | None = None,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype or torch.float32}
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels, kernel_size, kernel_size), **kw
        ))
        self.bias = nn.Parameter(torch.empty((out_channels,), **kw))
        self.padding = kernel_size // 2
        self.kernel_std = kernel_std

    @property
    def fan_in(self) -> int:
        return self.weight[0].numel()

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        bound = 1.0 / math.sqrt(self.fan_in)
        if self.kernel_std is None:
            # kaiming_uniform(a=sqrt(5)): gain sqrt(1/3) * sqrt(3/fan_in)
            _draw(self.weight,
                  lambda t, g: t.uniform_(-bound, bound, generator=g),
                  generator)
        else:
            std = self.kernel_std
            _draw(self.weight,
                  lambda t, g: t.normal_(0.0, std, generator=g),
                  generator)
        _draw(self.bias,
              lambda t, g: t.uniform_(-bound, bound, generator=g),
              generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: (B, H, W, C_in) -> (B, H, W, C_out), in ``x.dtype``."""
        y = F.conv2d(
            x.permute(0, 3, 1, 2),
            self.weight.to(x.dtype),
            self.bias.to(x.dtype),
            padding=self.padding,
        )
        return y.permute(0, 2, 3, 1)
