"""Fused LR/HR training-pair synthesis: a CUDA kernel and its plain version.

The counterpart of the JAX package's ``torchsr_tpu/ops/pallas/
preprocess.py`` ``synthesize_pair_pallas`` (its TPU kernel
``_pair_kernel``, preprocess.py:45): uint8 crops (B, S, S, 3) NHWC and
flip bits (B, 2) (column 0 reverses W, column 1 reverses H) give the f32
pair ``(lr, hr)``, HR in [0, 1] and LR its PIL bicubic downscale with
the uint8 quantization after each pass, W first.

A CUDA tensor runs ``csrc/pair_synth.cu`` (design and bound in its
header: one CTA a band of an image's LR rows, ``pair_plan``); a CPU
tensor runs the plain version, the port's
``data.preprocess.synthesize_pair``, which the Pallas kernel equals in
the JAX package.  ``synthesize_pair_bands_reference`` is the plain
version computed band by band as the kernel's CTAs do.  There is no
fallback: on CUDA the kernel runs or the call raises.  As in the JAX
package, the trainer keeps the plain version; the kernel's path is
``tools/bench_preprocess.py``.  The crops are square: one resampling
matrix serves both axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from torchsr_tpu_torch.data.preprocess import (
    _apply_flips,
    synthesize_pair as synthesize_pair_reference,
)
from torchsr_tpu_torch.ops.rdb import _raise_on
from torchsr_tpu_torch.ops.resize import (
    INV_255,
    _quantize_pixels,
    resample_matrix,
)

# Kernel launches on CUDA: one per call.  A run reads it to show that
# its path went through the kernel.
PAIR_SYNTH_LAUNCHES = 0
# Shared memory a block may take on the H100
_MAX_SMEM = 232448
# CTAs a call aims at: an image is cut into about this many over the
# batch's images bands of LR rows (one CTA each), at most one a row.  A
# band's window of HR rows reaches past its LR rows' share by the taps'
# reach, so more bands recompute more of the W pass: at (64, 96, 96, 3)
# two bands (128 CTAs) measured 0.0115 ms of device time and four 0.0134
# (NVIDIA H100 80GB HBM3, 700.00 W), while five 100 px crops ran fastest
# with twelve a crop.
BAND_CTAS = 128


def pair_bands(batch: int, lr_size: int) -> int:
    """The bands an image of ``lr_size`` LR rows is cut into in a call of
    ``batch`` images."""
    return max(1, min(lr_size, -(-BAND_CTAS // batch)))


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


@functools.cache
def pair_plan(size: int, lr_size: int, bands: int) -> dict:
    """How the kernel cuts an image of ``size`` px into ``bands`` bands of
    LR rows (``bands`` <= ``lr_size``), one CTA each: ``band`` (s, 2),
    each LR row's [lo, hi) of nonzero taps; ``taps`` (T, s) f32, column o
    row o's nonzero taps of the resampling matrix from lo(o); and per band
    (``bands``: o0, o1, w0, w1, h0, h1, t0, t1) its LR rows [o0, o1), the
    HR rows it stages [w0, w1) (flipped coordinates), its share of hr's
    rows [h0, h1) (the shares cut [0, size)) and the rows its passes read
    [t0, t1) (its rows' taps).  ``rows`` is the largest window, ``smem`` a
    CTA's shared memory."""
    mat = resample_matrix(size, lr_size)
    band = np.zeros((lr_size, 2), np.int32)
    for i, row in enumerate(mat):
        nz = np.flatnonzero(row)
        if nz.size:
            band[i] = nz[0], nz[-1] + 1
    n_taps = max(1, int((band[:, 1] - band[:, 0]).max()))
    taps = np.zeros((n_taps, lr_size), np.float32)
    for o, (lo, hi) in enumerate(band):
        taps[:hi - lo, o] = mat[o, lo:hi]
    nb = bands
    o_cut = [k * lr_size // nb for k in range(nb + 1)]
    h_cut = [o * size // lr_size for o in o_cut[:-1]] + [size]
    bands = []
    for k in range(nb):
        o0, o1 = o_cut[k], o_cut[k + 1]
        live = [(lo, hi) for lo, hi in band[o0:o1] if hi > lo]
        t0 = min((lo for lo, _ in live), default=h_cut[k])
        t1 = max((hi for _, hi in live), default=h_cut[k])
        bands.append(tuple(int(v) for v in (
            o0, o1, min(t0, h_cut[k]), max(t1, h_cut[k + 1]), h_cut[k],
            h_cut[k + 1], t0, t1)))
    rows = max(w1 - w0 for _, _, w0, w1, *_ in bands)
    return {"band": band, "taps": taps, "bands": bands, "rows": rows,
            "smem": (n_taps * lr_size + 3 * rows * lr_size + 2 * lr_size) * 4
            + 3 * rows * size}


@functools.cache
def _device_plan(size: int, lr_size: int, bands: int, index: int):
    """``pair_plan``'s taps and its int32 plan (band, then each band's
    row) on CUDA device ``index``."""
    plan = pair_plan(size, lr_size, bands)
    ints = np.concatenate([plan["band"].reshape(-1),
                           np.asarray(plan["bands"], np.int32).reshape(-1)])
    dev = torch.device("cuda", index)
    return (torch.from_numpy(plan["taps"]).to(dev),
            torch.from_numpy(ints.astype(np.int32)).to(dev))


@functools.cache
def _launch():
    """The kernel's entry, its argument types set once."""
    from torchsr_tpu_torch.ops._build import load_library

    lib = load_library("pair_synth")
    return lib.pair_synth_launch, lib.pair_synth_error_string


def synthesize_pair_bands_reference(
    crops_u8: torch.Tensor, flips: torch.Tensor, upscale_factor: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version computed as the kernel's CTAs compute it, band by
    band of ``pair_plan`` (``pair_bands`` of them an image): each band
    reads only its window's HR rows (an HR row outside every window, or an
    LR row no band covers, stays NaN), writes its share of hr, runs the W
    pass over its taps' rows and the H pass over its LR rows, with the
    plain version's arithmetic on the whole image's shapes."""
    _check(crops_u8, flips, upscale_factor)
    b, size = crops_u8.shape[0], crops_u8.shape[1]
    lr_size = size // upscale_factor
    plan = pair_plan(size, lr_size, pair_bands(b, lr_size))
    full = _apply_flips(crops_u8.float() * INV_255, flips)
    mat = torch.from_numpy(resample_matrix(size, lr_size)).to(full.device)
    hr = torch.full_like(full, float("nan"))
    lr = full.new_full((b, lr_size, lr_size, 3), float("nan"))
    for o0, o1, w0, w1, h0, h1, t0, t1 in plan["bands"]:
        # every product on the whole image's shape, as the plain version
        # takes it, from the band's window only (zeros elsewhere)
        window = torch.zeros_like(full)
        window[:, w0:w1] = full[:, w0:w1]
        hr[:, h0:h1] = window[:, h0:h1]
        mid = _quantize_pixels(torch.einsum("ow,bhwc->bhoc", mat, window))
        mid[:, :t0] = 0
        mid[:, t1:] = 0
        lr[:, o0:o1] = _quantize_pixels(
            torch.einsum("oh,bhwc->bowc", mat, mid))[:, o0:o1]
    return lr, hr


def synthesize_pair_cuda(
    crops_u8: torch.Tensor, flips: torch.Tensor, upscale_factor: int = 4,
) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 crops (B, S, S, 3) + flip bits (B, 2) -> ``(lr, hr)`` f32,
    on the crops' device: the kernel on CUDA, the plain version on the
    CPU.  On CUDA ``hr`` and ``lr`` are views of one allocation."""
    global PAIR_SYNTH_LAUNCHES
    _check(crops_u8, flips, upscale_factor)
    if crops_u8.device.type == "cpu":
        return synthesize_pair_reference(crops_u8, flips, upscale_factor)
    if crops_u8.device.type != "cuda":
        raise ValueError(
            f"synthesize_pair_cuda runs on CUDA (kernel) or CPU (plain "
            f"version), not on {crops_u8.device}")
    if flips.device != crops_u8.device:
        raise ValueError(
            f"flips must lie on {crops_u8.device}, not on {flips.device}")
    b, size = crops_u8.shape[0], crops_u8.shape[1]
    lr_size = size // upscale_factor
    bands = pair_bands(b, lr_size)
    plan = pair_plan(size, lr_size, bands)
    if plan["smem"] > _MAX_SMEM:
        raise ValueError(
            f"a {size} px crop's band needs {plan['smem']} bytes of shared "
            f"memory; a block has {_MAX_SMEM}")
    dev = crops_u8.device
    if not crops_u8.is_contiguous() or crops_u8.data_ptr() % 16:
        crops_u8 = crops_u8.clone(memory_format=torch.contiguous_format)
    # bool and uint8 flips are read as they are (a bool is a 0/1 byte)
    if flips.dtype not in (torch.bool, torch.uint8) or not \
            flips.is_contiguous():
        flips = flips.to(torch.uint8).contiguous()
    taps, ints = _device_plan(size, lr_size, bands, dev.index)
    n_hr = b * size * size * 3
    out = torch.empty(n_hr + b * lr_size * lr_size * 3, dtype=torch.float32,
                      device=dev)
    hr = out[:n_hr].view(b, size, size, 3)
    lr = out[n_hr:].view(b, lr_size, lr_size, 3)
    launch, error_string = _launch()
    err = launch(crops_u8.data_ptr(), flips.data_ptr(), taps.data_ptr(),
                 ints.data_ptr(), hr.data_ptr(), lr.data_ptr(), b, size,
                 lr_size, len(plan["bands"]), taps.shape[0], plan["rows"],
                 INV_255, dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, error_string, "pair_synth")
    PAIR_SYNTH_LAUNCHES += 1
    return lr, hr
