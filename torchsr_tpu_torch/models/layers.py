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
    num_batches_tracked).

    ``sync_group`` (a ``torch.distributed`` group, set by
    ``sync_batchnorm``): in training mode the batch statistics span the
    global batch of every rank, as the JAX package's BatchNorm over a
    sharded batch does: one all-reduce a call of the sums of
    (x - running mean) and its square and of the count, the JAX
    package's one-pass moments shifted by the running mean
    (``layers.py`` ``_TorchBN``), differentiable (the backward
    all-reduces their gradients)."""

    sync_group = None

    def __init__(self, channels: int, *, device=None, dtype=None):
        super().__init__(channels, eps=1e-5, momentum=0.1, device=device,
                         dtype=dtype or torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.sync_group is not None:
            return self._synced(x.float()).to(x.dtype)
        y = super().forward(x.permute(0, 3, 1, 2).float())
        return y.permute(0, 2, 3, 1).to(x.dtype)

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        from torchsr_tpu_torch.parallel.mesh import all_reduce_sum

        shift = self.running_mean.detach().clone()
        d = x - shift
        local = torch.cat([d.sum((0, 1, 2)), (d * d).sum((0, 1, 2)),
                           d.new_full((1,), d.numel() // d.shape[-1])])
        total = all_reduce_sum(local, self.sync_group)
        c = self.num_features
        count = total[2 * c]
        m1 = total[:c] / count
        var = (total[c:2 * c] / count - m1 * m1).clamp_min(0.0)
        mean = shift + m1
        with torch.no_grad():  # no host read: a CUDA graph captures it
            unbiased = count / (count - 1.0).clamp_min(1.0)
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach() * unbiased, self.momentum)
            self.num_batches_tracked.add_(1)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def sync_batchnorm(module: nn.Module, group) -> nn.Module:
    """Every ``BatchNorm`` of ``module`` to statistics over ``group``'s
    global batch (None: each process's own batch)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.sync_group = group
    return module
