"""ESRGAN RRDB generator and discriminator on NHWC tensors.

The PyTorch counterpart of ``torchsr_tpu/models/esrgan.py``: the same
graphs, parameters in f32, compute in ``compute_dtype`` (bf16 under AMP
on CUDA), and the outputs cast to f32.

  conv3(3->64) -> 23 RRDB (each 3 residual dense blocks of 5 dense
  convs, growth 32, residual scale 0.2) -> conv3 trunk -> long skip ->
  log2(scale) x [nearest x2 + conv3 + LeakyReLU] -> conv3 + LeakyReLU
  -> conv3(64->3).

Every residual dense block runs through ``ops.rdb.fused_rdb``: the CUDA
kernels on the card (forward, and backward when trained), the plain
versions on the CPU.  The final conv is a
plain conv; the JAX ``SubpixelSpaceConv`` tail is an exact relayout of
it.  ``state_dict`` keys are the reference's (``conv1``,
``blocks.{i}.RDB{j}.conv{1..4}.0``, ``blocks.{i}.RDB{j}.conv5``,
``conv2``, ``upsample{k}``, ``conv3.0``, ``conv4``), so a reference
``.pth`` loads as it is.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from torchsr_tpu_torch.models.layers import BatchNorm, Conv, Dense, leaky_relu
from torchsr_tpu_torch.ops.rdb import CHANNELS, CIN, COUT, fused_rdb
from torchsr_tpu_torch.ops.resize import nearest_upsample

NUM_RESIDUAL = 23


def _rdb_std(fan_in: int) -> float:
    """kaiming-normal (gain sqrt 2, fan_in) scaled by 0.1."""
    return 0.1 * math.sqrt(2.0 / fan_in)


class ResidualDenseBlock(nn.Module):
    """Five dense convs, each seeing all earlier outputs; x + 0.2 * conv5.

    The forward hands the HWIO kernels to ``fused_rdb``: in training,
    permuted f32 views of the OIHW weights (the bf16 kernels round them
    as they pack them); under ``torch.inference_mode``, contiguous
    copies in the activation dtype, cached on that dtype and the
    weights' storage and version counters, so a serving loop repacks
    only after the weights change."""

    def __init__(self, scale_ratio: float = 0.2, *, device=None,
                 dtype=None):
        super().__init__()
        self.scale_ratio = scale_ratio
        kw = {"device": device, "dtype": dtype}
        for i in range(4):
            conv = Conv(CIN[i], COUT[i], kernel_std=_rdb_std(9 * CIN[i]),
                        **kw)
            # (conv, activation) as in the reference: keys conv{i}.0.*
            setattr(self, f"conv{i + 1}",
                    nn.Sequential(conv, nn.LeakyReLU(0.2)))
        self.conv5 = Conv(CIN[4], COUT[4], kernel_std=_rdb_std(9 * CIN[4]),
                          **kw)
        self._packed: tuple | None = None

    def convs(self) -> tuple:
        return (self.conv1[0], self.conv2[0], self.conv3[0],
                self.conv4[0], self.conv5)

    def _kernels(self, dtype: torch.dtype) -> tuple:
        convs = self.convs()
        if not torch.is_inference_mode_enabled():
            return tuple(c.weight.permute(2, 3, 1, 0) for c in convs)
        key = (dtype, tuple((c.weight.data_ptr(), c.weight._version)
                            for c in convs))
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, tuple(
                c.weight.permute(2, 3, 1, 0).to(dtype).contiguous()
                for c in convs
            ))
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 64) -> (B, H, W, 64) in ``x.dtype``."""
        return fused_rdb(
            x, self._kernels(x.dtype), tuple(c.bias for c in self.convs()),
            scale_ratio=self.scale_ratio,
        )


class RRDB(nn.Module):
    """Residual-in-residual dense block: 3 RDBs with a scaled skip."""

    def __init__(self, scale_ratio: float = 0.2, *, device=None,
                 dtype=None):
        super().__init__()
        self.scale_ratio = scale_ratio
        self.RDB1 = ResidualDenseBlock(scale_ratio, device=device,
                                       dtype=dtype)
        self.RDB2 = ResidualDenseBlock(scale_ratio, device=device,
                                       dtype=dtype)
        self.RDB3 = ResidualDenseBlock(scale_ratio, device=device,
                                       dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.RDB3(self.RDB2(self.RDB1(x)))
        return out * self.scale_ratio + x


class ESRGANGenerator(nn.Module):
    """ESRGAN RRDB generator; NHWC in/out, [0, 1] pixel space.

    ``scale_factor`` (a power of two) sets the number of nearest + conv
    upsample stages.  ``compute_dtype`` is the activation dtype (None =
    f32); parameters are stored in ``dtype`` (f32).  ``generator`` seeds
    the initialization: RDB kernels kaiming-normal x 0.1, everything
    else torch's defaults.
    """

    def __init__(
        self,
        scale_factor: int = 4,
        num_rrdb_blocks: int = NUM_RESIDUAL,
        *,
        compute_dtype: torch.dtype | None = None,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        n_up = int(math.log2(scale_factor))
        if 2 ** n_up != scale_factor:
            raise ValueError(
                f"scale_factor must be a power of two, got {scale_factor}"
            )
        self.scale_factor = scale_factor
        self.num_rrdb_blocks = num_rrdb_blocks
        self.compute_dtype = compute_dtype
        kw = {"device": device, "dtype": dtype}
        self.conv1 = Conv(3, CHANNELS, **kw)
        self.blocks = nn.Sequential(
            *[RRDB(**kw) for _ in range(num_rrdb_blocks)]
        )
        self.conv2 = Conv(CHANNELS, CHANNELS, **kw)
        for i in range(n_up):
            setattr(self, f"upsample{i + 1}", Conv(CHANNELS, CHANNELS, **kw))
        self.conv3 = nn.Sequential(Conv(CHANNELS, CHANNELS, **kw),
                                   nn.LeakyReLU(0.2))
        self.conv4 = Conv(CHANNELS, 3, **kw)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None) -> None:
        for module in self.modules():
            if isinstance(module, Conv):
                module.reset_parameters(generator)

    def upsamplers(self) -> list:
        return [getattr(self, f"upsample{i + 1}")
                for i in range(int(math.log2(self.scale_factor)))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) in [0, 1] -> (B, sH, sW, 3) float32."""
        x = x.to(self.compute_dtype or torch.float32)
        conv1 = self.conv1(x).contiguous()
        out = self.conv2(self.blocks(conv1))
        out = conv1 + out
        for up in self.upsamplers():
            out = leaky_relu(up(nearest_upsample(out, 2)), 0.2)
        out = leaky_relu(self.conv3[0](out), 0.2)
        return self.conv4(out).float()



# (channels, stride, batch norm) of the discriminator's ten conv stages
DISC_STAGES = (
    (64, 1, False), (64, 2, True), (128, 1, True), (128, 2, True),
    (256, 1, True), (256, 2, True), (512, 1, True), (512, 2, True),
    (512, 1, True), (512, 2, True),
)


class ESRGANDiscriminator(nn.Module):
    """ESRGAN discriminator on NHWC images; returns raw logits (B, 1)
    in f32.

    Ten 3x3 conv stages (five of stride 2), BatchNorm on all but the
    first, LeakyReLU(0.2), then ``Dense(100)``, LeakyReLU, ``Dense(1)``.
    Module layout and keys are the reference's: ``features.{i}`` an
    ``nn.Sequential`` of conv / BatchNorm / activation (convs at 0, 2,
    5, ..., 26; BatchNorms at 3, 6, ..., 27) and ``classifier.{0,2}``.
    The classifier reads the final (512, image_size / 32, image_size /
    32) map flattened in CHW order, as the reference's ``torch.flatten``
    of NCHW does.  ``compute_dtype`` as the generator's; BatchNorm
    statistics stay f32.
    """

    def __init__(
        self,
        image_size: int = 128,
        *,
        compute_dtype: torch.dtype | None = None,
        device=None,
        dtype=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if image_size % 32:
            raise ValueError(
                f"image_size must be a multiple of 32, got {image_size}"
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
        fm = image_size // 32
        self.classifier = nn.Sequential(
            Dense(512 * fm * fm, 100, **kw), nn.LeakyReLU(0.2),
            Dense(100, 1, **kw),
        )
        for module in self.modules():
            if isinstance(module, (Conv, Dense)):
                module.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) -> (B, 1) f32 logits; BatchNorm uses batch
        statistics (and updates its running ones) in train mode."""
        out = self.features(x.to(self.compute_dtype or torch.float32))
        out = out.permute(0, 3, 1, 2).reshape(out.shape[0], -1)
        return self.classifier(out).float()
