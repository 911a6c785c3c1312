"""Fused LR/HR training-pair synthesis: a CUDA kernel and its plain version.

The counterpart of the JAX package's ``torchsr_tpu/ops/pallas/
preprocess.py`` ``synthesize_pair_pallas`` (its TPU kernel
``_pair_kernel``, preprocess.py:45): uint8 crops (B, S, S, 3) NHWC and
flip bits (B, 2) (column 0 reverses W, column 1 reverses H) give the f32
pair ``(lr, hr)``, HR in [0, 1] and LR its PIL bicubic downscale with
the uint8 quantization after each pass, W first.

A CUDA tensor runs ``csrc/pair_synth.cu`` (design and bound in its
header); a CPU tensor runs the plain version, the port's
``data.preprocess.synthesize_pair``, which the Pallas kernel equals in
the JAX package.  There is no fallback: on CUDA the kernel runs or the
call raises.  As in the JAX package, the trainer keeps the plain
version; the kernel's path is ``tools/bench_preprocess.py``.  The crops
are square: one resampling matrix serves both axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from torchsr_tpu_torch.data.preprocess import (
    synthesize_pair as synthesize_pair_reference,
)
from torchsr_tpu_torch.ops.rdb import _raise_on
from torchsr_tpu_torch.ops.resize import INV_255, resample_matrix

# Kernel launches on CUDA: one per call.  A run reads it to show that
# its path went through the kernel.
PAIR_SYNTH_LAUNCHES = 0
# Shared memory a block may take on the H100 (one CTA holds one crop)
_MAX_SMEM = 232448


def _check(crops_u8: torch.Tensor, flips: torch.Tensor,
           upscale_factor: int) -> None:
    if crops_u8.dim() != 4 or crops_u8.shape[-1] != 3:
        raise ValueError(
            f"crops must be NHWC (B, S, S, 3), got {tuple(crops_u8.shape)}")
    if crops_u8.shape[1] != crops_u8.shape[2]:
        raise ValueError(
            f"pair synthesis takes square crops, got "
            f"{tuple(crops_u8.shape[1:3])}")
    if crops_u8.dtype != torch.uint8:
        raise TypeError(f"crops must be uint8, not {crops_u8.dtype}")
    if tuple(flips.shape) != (crops_u8.shape[0], 2):
        raise ValueError(
            f"flips must be (B, 2) beside crops {tuple(crops_u8.shape)}, "
            f"got {tuple(flips.shape)}")
    if crops_u8.shape[1] // upscale_factor < 1:
        raise ValueError(
            f"crop {crops_u8.shape[1]} is smaller than the factor "
            f"{upscale_factor}")


@functools.lru_cache(maxsize=16)
def _matrix(size: int, lr_size: int, device: torch.device):
    """The (s, S) resampling matrix and each row's [lo, hi) band of
    nonzero taps, on ``device``."""
    mat = resample_matrix(size, lr_size)
    band = np.zeros((lr_size, 2), np.int32)
    for i, row in enumerate(mat):
        nz = np.flatnonzero(row)
        if nz.size:
            band[i] = nz[0], nz[-1] + 1
    return (torch.from_numpy(mat).to(device),
            torch.from_numpy(band).to(device))


def synthesize_pair_cuda(
    crops_u8: torch.Tensor, flips: torch.Tensor, upscale_factor: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 crops (B, S, S, 3) + flip bits (B, 2) -> ``(lr, hr)`` f32,
    on the crops' device: the kernel on CUDA, the plain version on the
    CPU."""
    global PAIR_SYNTH_LAUNCHES
    _check(crops_u8, flips, upscale_factor)
    if crops_u8.device.type == "cpu":
        return synthesize_pair_reference(crops_u8, flips, upscale_factor)
    if crops_u8.device.type != "cuda":
        raise ValueError(
            f"synthesize_pair_cuda runs on CUDA (kernel) or CPU (plain "
            f"version), not on {crops_u8.device}")
    from torchsr_tpu_torch.ops._build import load_library

    if flips.device != crops_u8.device:
        raise ValueError(
            f"flips must lie on {crops_u8.device}, not on {flips.device}")
    b, size = crops_u8.shape[0], crops_u8.shape[1]
    lr_size = size // upscale_factor
    smem = size * lr_size * 3 * 4 + size * size * 3
    if smem > _MAX_SMEM:
        raise ValueError(
            f"a {size} px crop needs {smem} bytes of shared memory; a "
            f"block has {_MAX_SMEM}")
    dev = crops_u8.device
    crops_u8 = crops_u8.contiguous()
    flips = flips.to(torch.uint8).contiguous()
    mat, band = _matrix(size, lr_size, dev)
    hr = torch.empty((b, size, size, 3), dtype=torch.float32, device=dev)
    lr = torch.empty((b, lr_size, lr_size, 3), dtype=torch.float32,
                     device=dev)
    lib = load_library("pair_synth")
    err = lib.pair_synth_launch(
        crops_u8.data_ptr(), flips.data_ptr(), mat.data_ptr(),
        band.data_ptr(), hr.data_ptr(), lr.data_ptr(), b, size, lr_size,
        INV_255, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib.pair_synth_error_string, "pair_synth")
    PAIR_SYNTH_LAUNCHES += 1
    return lr, hr
