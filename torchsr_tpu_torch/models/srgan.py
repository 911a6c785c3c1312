"""SRGAN generator and discriminator on NHWC tensors.

The PyTorch counterpart of ``torchsr_tpu/models/srgan.py``: the same
graphs, parameters in f32, compute in ``compute_dtype`` (bf16 under AMP
on CUDA), BatchNorm statistics in f32, and the outputs cast to f32.

  generator: conv9x9(3->64) + PReLU -> 16 x [conv3-BN-PReLU-conv3-BN +
    skip] -> conv3 + BN -> long skip -> log2(scale) x [conv3(64->256),
    pixel shuffle x2, PReLU] -> conv9x9(64->3); no output activation.
  discriminator: 8 conv3 stages 64->512, strides 1/2 in turn, BN and
    LeakyReLU(0.2) (no BN on the first), flatten, Linear->1024,
    LeakyReLU, Linear->1, sigmoid in f32.

No TPU kernel is on this path: every layer is a plain PyTorch op.  The
9x9 64->3 head runs, as the JAX generator's ``fused_head`` does, in
subpixel space (``ops/subpixel_conv.py``): at 4x the last upsample
stage skips its pixel shuffle (its PReLU has one scalar slope, so it
commutes) and the head consumes the pre-shuffle map through a
partially folded kernel; at 2x and 8x it folds the HR map.  The
``fused_head`` attribute picks it (None: the subpixel form on CUDA
where ``FUSED_HEAD_ON_CUDA`` says so, the direct conv on the CPU);
both compute the same conv with the same parameters.  ``state_dict`` keys are the
reference's (``conv1.{0,1}``, ``blocks.{i}.conv1/bn1/prelu/conv2/bn2``,
``conv2.{0,1}``, ``conv_layers.{i}.conv/prelu``, ``conv3``;
``features.{i}``, ``classifier.{0,2}``), so a reference ``.pth`` loads
as it is.  BatchNorm follows the module's mode: batch statistics (and
running-statistics updates) in ``train()``, the running statistics in
``eval()``, the JAX package's ``train=True`` / ``train=False``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from torchsr_tpu_torch.models.layers import BatchNorm, Conv, Dense, PReLU
from torchsr_tpu_torch.ops.pixel_shuffle import depth_to_space
from torchsr_tpu_torch.ops.subpixel_conv import (
    conv_head_partially_folded,
    conv_subpixel_space,
)

NUM_RESIDUAL = 16
CHANNELS = 64
# the head's form on CUDA when ``fused_head`` is None (the faster one
# on the H100: PERF.md)
FUSED_HEAD_ON_CUDA = True


def _reset(module: nn.Module, generator: torch.Generator | None) -> None:
    """torch-default draws for every conv and dense layer, in module
    order, from ``generator``."""
    for m in module.modules():
        if isinstance(m, (Conv, Dense)):
            m.reset_parameters(generator)


class ResidualBlock(nn.Module):
    """conv3-BN-PReLU-conv3-BN with an identity skip (64 channels)."""

    def __init__(self, channels: int = CHANNELS, *, device=None,
                 dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.conv1 = Conv(channels, channels, bias=False, **kw)
        self.bn1 = BatchNorm(channels, **kw)
        self.prelu = PReLU(**kw)
        self.conv2 = Conv(channels, channels, bias=False, **kw)
        self.bn2 = BatchNorm(channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.prelu(self.bn1(self.conv1(x)))
        return self.bn2(self.conv2(out)) + x


class SubpixelConv(nn.Module):
    """conv3(C -> 4C), pixel shuffle x2, PReLU: one x2 upsample stage."""

    def __init__(self, channels: int = CHANNELS, *, device=None,
                 dtype=None):
        super().__init__()
        self.conv = Conv(channels, channels * 4, device=device, dtype=dtype)
        self.prelu = PReLU(device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, shuffle: bool = True) -> torch.Tensor:
        """``shuffle=False`` leaves the output folded (B, H, W, 4C)."""
        y = self.conv(x)
        return self.prelu(depth_to_space(y, 2) if shuffle else y)


class SRGANGenerator(nn.Module):
    """SRGAN generator; NHWC in/out, [0, 1] pixel space.

    ``scale_factor`` (a power of two) sets the number of subpixel
    stages.  ``compute_dtype`` is the activation dtype (None = f32);
    parameters are stored in ``dtype`` (f32).  ``generator`` seeds the
    torch-default initialization; PReLU slopes start at 0.25 and
    BatchNorms at scale 1, bias 0, as in the JAX package.
    ``fused_head``: the head in subpixel space (module docstring).
    """

    def __init__(
        self,
        scale_factor: int = 4,
        num_residual: int = NUM_RESIDUAL,
        *,
        compute_dtype: torch.dtype | None = None,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
        fused_head: bool | None = None,
    ):
        super().__init__()
        n_up = int(math.log2(scale_factor))
        if 2 ** n_up != scale_factor:
            raise ValueError(
                f"scale_factor must be a power of two, got {scale_factor}"
            )
        self.scale_factor = scale_factor
        self.num_residual = num_residual
        self.compute_dtype = compute_dtype
        self.fused_head = fused_head
        kw = {"device": device, "dtype": dtype}
        self.conv1 = nn.Sequential(Conv(3, CHANNELS, 9, **kw), PReLU(**kw))
        self.blocks = nn.Sequential(
            *[ResidualBlock(**kw) for _ in range(num_residual)])
        self.conv2 = nn.Sequential(
            Conv(CHANNELS, CHANNELS, bias=False, **kw),
            BatchNorm(CHANNELS, **kw))
        self.conv_layers = nn.Sequential(
            *[SubpixelConv(**kw) for _ in range(n_up)])
        self.conv3 = Conv(CHANNELS, 3, 9, **kw)
        _reset(self, generator)

    @classmethod
    def sized_to(cls, state: dict, **kw) -> "SRGANGenerator":
        """A generator with the residual-block count and scale of a
        ``state_dict`` (``blocks.{i}``, ``conv_layers.{i}``)."""
        blocks = len({k.split(".")[1] for k in state
                      if k.startswith("blocks.")})
        n_up = len({k.split(".")[1] for k in state
                    if k.startswith("conv_layers.")})
        return cls(scale_factor=2 ** n_up if n_up else 4,
                   num_residual=blocks or NUM_RESIDUAL, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, sH, sW, 3) float32."""
        conv1 = self.conv1(x.to(self.compute_dtype or torch.float32))
        out = conv1 + self.conv2(self.blocks(conv1))
        return self.tail(out).float()

    def uses_fused_head(self, x: torch.Tensor) -> bool:
        if self.fused_head is not None:
            return self.fused_head
        return x.is_cuda and FUSED_HEAD_ON_CUDA

    def tail(self, out: torch.Tensor) -> torch.Tensor:
        """The upsample stages and the head, from the trunk's output."""
        fused = self.uses_fused_head(out)
        fold_last = fused and self.scale_factor == 4
        n_up = len(self.conv_layers)
        for i, stage in enumerate(self.conv_layers):
            out = stage(out, shuffle=not (fold_last and i == n_up - 1))
        if fold_last:
            return conv_head_partially_folded(
                out, self.conv3.weight, self.conv3.bias, 4, 2)
        return self.head(out, fused)

    def head(self, up: torch.Tensor, fused: bool | None = None):
        """The 9x9 head on the HR map ``up``: direct, or in subpixel
        space (``fused``; None: ``uses_fused_head``)."""
        if fused is None:
            fused = self.uses_fused_head(up)
        if fused:
            return conv_subpixel_space(up, self.conv3.weight,
                                       self.conv3.bias, self.scale_factor)
        return self.conv3(up)


# (channels, stride, batch norm) of the discriminator's conv stages
DISC_STAGES = (
    (64, 1, False), (64, 2, True), (128, 1, True), (128, 2, True),
    (256, 1, True), (256, 2, True), (512, 1, True), (512, 2, True),
)


class SRGANDiscriminator(nn.Module):
    """SRGAN discriminator on NHWC images; returns probabilities (B, 1)
    in f32.

    Module layout and keys are the reference's: ``features.{i}`` an
    ``nn.Sequential`` of conv / BatchNorm / LeakyReLU (convs at 0, 2, 5,
    ..., 20; BatchNorms at 3, 6, ..., 21) and ``classifier.{0,2}``.  The
    classifier reads the final (512, image_size / 16, image_size / 16)
    map flattened in CHW order, as the reference's ``torch.flatten`` of
    NCHW does.  ``compute_dtype`` as the generator's; the sigmoid runs
    in f32.
    """

    def __init__(
        self,
        image_size: int = 96,
        *,
        compute_dtype: torch.dtype | None = None,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if image_size % 16:
            raise ValueError(
                f"image_size must be a multiple of 16, got {image_size}"
            )
        self.compute_dtype = compute_dtype
        kw = {"device": device, "dtype": dtype}
        layers: list = []
        in_ch = 3
        for feat, stride, use_bn in DISC_STAGES:
            layers.append(Conv(in_ch, feat, stride=stride, bias=not use_bn,
                               **kw))
            if use_bn:
                layers.append(BatchNorm(feat, **kw))
            layers.append(nn.LeakyReLU(0.2))
            in_ch = feat
        self.features = nn.Sequential(*layers)
        fm = image_size // 16
        self.classifier = nn.Sequential(
            Dense(512 * fm * fm, 1024, **kw), nn.LeakyReLU(0.2),
            Dense(1024, 1, **kw),
        )
        _reset(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, 1) f32 probabilities; BatchNorm uses
        batch statistics (and updates its running ones) in train mode."""
        out = self.features(x.to(self.compute_dtype or torch.float32))
        out = out.permute(0, 3, 1, 2).reshape(out.shape[0], -1)
        return torch.sigmoid(self.classifier(out).float())
