"""Building blocks on NHWC tensors with torch-default initialization.

``Conv`` holds an OIHW ``weight`` and a ``bias`` (the ``nn.Conv2d`` key
names, so reference state_dicts load as they are) and runs on NHWC
activations: the conv sees an NCHW *view* of a contiguous NHWC tensor,
which is PyTorch's ``channels_last`` memory format, so no layout copy
is made.  Padding is ``k // 2`` on every side, as in torch.

``Dense`` is ``nn.Linear``'s layout computed in the input's dtype,
``PReLU`` one shared slope (``nn.PReLU()``'s key), and ``BatchNorm``
is ``nn.BatchNorm2d`` on NHWC tensors with its statistics in f32
whatever the compute dtype (the JAX package's ``BatchNorm``).

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
    torch's uniform(+-1/sqrt(fan_in)) either way; ``bias=False`` drops
    it (the convs before a BatchNorm).  ``stride`` > 1 keeps torch's
    symmetric ``k // 2`` padding.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        *,
        stride: int = 1,
        bias: bool = True,
        kernel_std: float | None = None,
        device=None,
        dtype=None,
    ):
        super().__init__()
        kw = {"device": device, "dtype": dtype or torch.float32}
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels, kernel_size, kernel_size), **kw
        ))
        if bias:
            self.bias = nn.Parameter(torch.empty((out_channels,), **kw))
        else:
            self.register_parameter("bias", None)
        self.stride = stride
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
        if self.bias is not None:
            _draw(self.bias,
                  lambda t, g: t.uniform_(-bound, bound, generator=g),
                  generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: (B, H, W, C_in) -> (B, H/s, W/s, C_out), in ``x.dtype``."""
        y = F.conv2d(
            x.permute(0, 3, 1, 2),
            self.weight.to(x.dtype),
            None if self.bias is None else self.bias.to(x.dtype),
            stride=self.stride,
            padding=self.padding,
        )
        return y.permute(0, 2, 3, 1)


class Dense(nn.Module):
    """Fully connected layer (``nn.Linear`` keys and torch default
    init), computed in the input's dtype."""

    def __init__(self, in_features: int, out_features: int, *,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype or torch.float32}
        self.weight = nn.Parameter(
            torch.empty((out_features, in_features), **kw))
        self.bias = nn.Parameter(torch.empty((out_features,), **kw))

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        for param in (self.weight, self.bias):
            _draw(param,
                  lambda t, g: t.uniform_(-bound, bound, generator=g),
                  generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class PReLU(nn.Module):
    """Parametric ReLU with one shared learnable slope (init 0.25), the
    JAX package's ``layers.PReLU`` under ``nn.PReLU()``'s key
    (``weight``, shape (1,)); the slope is cast to the input's dtype."""

    def __init__(self, init: float = 0.25, *, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full(
            (1,), init, device=device, dtype=dtype or torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm on NHWC tensors with torch semantics (momentum 0.1, eps
    1e-5, unbiased running variance), the JAX package's
    ``layers.BatchNorm``: statistics and normalization in f32 whatever
    the compute dtype, the output cast back to it.  ``nn.BatchNorm2d``
    keys (weight, bias, running_mean, running_var,
    num_batches_tracked)."""

    def __init__(self, channels: int, *, device=None, dtype=None):
        super().__init__(channels, eps=1e-5, momentum=0.1, device=device,
                         dtype=dtype or torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x.permute(0, 3, 1, 2).float())
        return y.permute(0, 2, 3, 1).to(x.dtype)
