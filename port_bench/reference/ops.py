"""Convolutions and dense products at a stated operand precision.

``f32`` leaves the operands as they are.  ``bf16`` rounds both operands
of each product to bfloat16 (and the gradient flowing back into them).
``fp8`` scales each operand by its absolute maximum onto float8 e4m3's
range, rounds it there and scales back (per-tensor scaling, the usual
fp8 recipe), and rounds the gradient flowing back the same way onto
e5m2.  Sums stay f32 in every mode.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "bf16", "fp8")


def _round_fp8(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / top
    return (t.float() / scale).to(dtype).float() * scale


def round_to(t: torch.Tensor, prec: str, grad: bool = False) -> torch.Tensor:
    """``t`` rounded to ``prec`` (gradients: e5m2 for ``fp8``)."""
    if prec == "f32":
        return t
    if prec == "bf16":
        return t.to(torch.bfloat16).float()
    if prec == "fp8":
        return _round_fp8(t, torch.float8_e5m2 if grad
                          else torch.float8_e4m3fn)
    raise ValueError(f"unknown precision {prec!r}; one of {PRECISIONS}")


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, prec):
        ctx.prec = prec
        return round_to(t, prec)

    @staticmethod
    def backward(ctx, g):
        return round_to(g, ctx.prec, grad=True), None


def operand(t: torch.Tensor, prec: str) -> torch.Tensor:
    """A product's operand at ``prec``; its gradient rounded alike."""
    if prec == "f32":
        return t
    return _Rounded.apply(t, prec)


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
         prec: str = "f32", stride: int = 1) -> torch.Tensor:
    """``k x k`` convolution, padding ``k // 2``, NCHW, OIHW weights."""
    return F.conv2d(operand(x, prec), operand(w, prec), b, stride=stride,
                    padding=w.shape[-1] // 2)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          prec: str = "f32") -> torch.Tensor:
    return F.linear(operand(x, prec), operand(w, prec), b)


def lrelu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm with the batch's statistics (biased variance), as a
    BatchNorm normalizes in training mode."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * weight[None, :, None, None]
            + bias[None, :, None, None])


def batch_norm_eval(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    mean: torch.Tensor, var: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm on running statistics."""
    scale = weight * torch.rsqrt(var + eps)
    return (x - mean[None, :, None, None]) * scale[None, :, None, None] \
        + bias[None, :, None, None]


def prelu(x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """PReLU with one shared slope."""
    return torch.where(x >= 0, x, slope * x)


def nearest2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def pixel_shuffle2(x: torch.Tensor) -> torch.Tensor:
    """``nn.PixelShuffle(2)``: channel c*4 + i*2 + j to offset (i, j)."""
    return F.pixel_shuffle(x, 2)


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN and matmul inside the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
