"""Polyphase (subpixel-space) convolution for few-channel HR heads.

The port of ``torchsr_tpu/ops/subpixel_conv.py``.  The SRGAN generator
ends with a 9x9 conv from 64 channels to 3 at full HR resolution, and
the ESRGAN generator with a 3x3 one; a 3-output-channel conv cannot
fill a tensor core's tile.  This module computes the same convolution
in subpixel space: the HR tensor is ``space_to_depth``-folded by the
upscale factor r, the HR kernel is repacked exactly into a KxK kernel
over C*r^2 input and Co*r^2 output channels (zero where an HR tap falls
outside the k x k support), and the result is ``depth_to_space``d.
For HR position y = r*Y + p and tap offset dy, y + dy = r*(Y + D) + i
with D = floor((p + dy) / r) and i = (p + dy) mod r, so each (phase p,
phase i) pair maps to one HR tap per LR displacement D.

Kernels are torch's OIHW (``Co, C, k, k``) and activations NHWC, as in
``models/layers.py``; channel orders are those of ``ops/pixel_shuffle``
(torch's ``PixelShuffle``).  The repacking is a differentiable gather;
its index tensors are built from ``torch.arange`` on the kernel's
device inside the call (a few small kernels), so a CUDA-graph capture
or a ``torch.export`` traces them like any other op.  The conv itself
is one ``F.conv2d``.  Only the f32 summation order differs from the
direct conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from torchsr_tpu_torch.ops.pixel_shuffle import depth_to_space, space_to_depth


def _phase_indices(k: int, r: int, device=None):
    """Gather indices and mask for repacking a k-tap axis at scale r:
    (taps K, HR tap index (K, r input phases, r output phases), valid
    mask of the same shape, LR padding (lo, hi))."""
    half = k // 2
    d_min = -((half + r - 1) // r)          # floor((0 - half) / r)
    d_max = (r - 1 + half) // r
    taps = d_max - d_min + 1
    a = torch.arange(taps, device=device)[:, None, None]
    i = torch.arange(r, device=device)[None, :, None]
    p = torch.arange(r, device=device)[None, None, :]
    idx = (d_min + a) * r + i - p + half
    valid = (idx >= 0) & (idx < k)
    return taps, idx.clamp(0, k - 1), valid, (-d_min, d_max)


def _repack(w: torch.Tensor, taps: int, idx: torch.Tensor,
            valid: torch.Tensor, g: int, r: int) -> torch.Tensor:
    """The (Co*r^2, C*g^2, taps, taps) kernel of OIHW ``w``: input
    channels (ci, i, j) at in-phases g, output channels (co, p, q) at
    out-phases r, from the (taps, g, r) tap index and mask."""
    co, c, k, _ = w.shape
    m = valid.to(w.dtype)
    w1 = w.index_select(2, idx.reshape(-1)).reshape(co, c, taps, g, r, k)
    w1 = w1 * m.reshape(1, 1, taps, g, r, 1)
    w2 = w1.index_select(5, idx.reshape(-1))
    w2 = w2.reshape(co, c, taps, g, r, taps, g, r)
    w2 = w2 * m.reshape(1, 1, 1, 1, 1, taps, g, r)
    # (co, ci, ay, i, p, ax, j, q) -> (co, p, q, ci, i, j, ay, ax)
    w2 = w2.permute(0, 4, 7, 1, 3, 6, 2, 5)
    return w2.reshape(co * r * r, c * g * g, taps, taps)


def subpixel_space_kernel(w: torch.Tensor, scale: int):
    """Repack an OIHW HR kernel (Co, C, k, k) into subpixel space:
    the (Co*r^2, C*r^2, K, K) kernel and the LR padding ((lo, hi) a
    spatial axis) that reproduces SAME at HR."""
    taps, idx, valid, pad = _phase_indices(w.shape[2], scale, w.device)
    return _repack(w, taps, idx, valid, scale, scale), (pad, pad)


def _conv_nhwc(x: torch.Tensor, kernel: torch.Tensor,
               bias: torch.Tensor | None, stride: int,
               padding: tuple) -> torch.Tensor:
    """``F.conv2d`` of NHWC ``x`` (a channels_last view) with
    ``padding`` ((lo, hi) for H, then W): symmetric ``lo`` where it
    gives the same output size (the extra ``hi`` rows are then never
    read), else an explicit pad."""
    taps = kernel.shape[2]
    sizes = x.shape[1:3]
    xc = x.permute(0, 3, 1, 2)
    if all((n + lo + hi - taps) // stride == (n + 2 * lo - taps) // stride
           for n, (lo, hi) in zip(sizes, padding)):
        y = F.conv2d(xc, kernel, bias, stride=stride,
                     padding=(padding[0][0], padding[1][0]))
    else:
        (lh, hh), (lw, hw) = padding
        y = F.conv2d(F.pad(xc, (lw, hw, lh, hh)), kernel, bias,
                     stride=stride)
    return y.permute(0, 2, 3, 1)


def conv_subpixel_space(x_hr: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor | None, scale: int) -> torch.Tensor:
    """SAME conv of an NHWC HR tensor by OIHW ``w`` (and bias ``b``),
    computed in subpixel space, in ``x_hr``'s dtype."""
    r = scale
    kernel, padding = subpixel_space_kernel(w.to(x_hr.dtype), r)
    bias = None if b is None else b.to(x_hr.dtype).repeat_interleave(r * r)
    out = _conv_nhwc(space_to_depth(x_hr, r), kernel, bias, 1, padding)
    return depth_to_space(out, r)


def _partial_fold_indices(k: int, r: int, g: int, device=None):
    """Gather indices and mask for one axis of the partially folded head
    conv (input folded at ``g``, output at ``r``, stride r // g in the
    g-folded grid): for output phase ro and HR tap offset dy the source
    is g-cell a at in-cell phase p with g*a + p = ro + dy.  Returns
    (taps A, HR tap index (A, g, r), valid mask, (lo, hi) padding in
    g-cells)."""
    half = k // 2
    a_min = -half // g                    # floor
    a_max = ((r - 1) + half) // g
    taps = a_max - a_min + 1
    a = torch.arange(taps, device=device)[:, None, None] + a_min
    p = torch.arange(g, device=device)[None, :, None]
    ro = torch.arange(r, device=device)[None, None, :]
    idx = g * a + p - ro + half
    valid = (idx >= 0) & (idx < k)
    return taps, idx.clamp(0, k - 1), valid, (-a_min, a_max)


def partial_fold_kernel(w: torch.Tensor, scale: int, in_fold: int):
    """Repack an OIHW HR kernel for input left folded at ``in_fold``
    (the pre-``depth_to_space`` map of a subpixel upsample, channels
    (C, p, q)), output folded at ``scale``: the (Co*scale^2,
    C*in_fold^2, A, A) kernel, the padding and the stride
    (scale // in_fold)."""
    r, g = scale, in_fold
    if r % g:
        raise ValueError(f"scale {r} not divisible by in_fold {g}")
    taps, idx, valid, pad = _partial_fold_indices(w.shape[2], r, g,
                                                  w.device)
    return _repack(w, taps, idx, valid, g, r), (pad, pad), r // g


def conv_head_partially_folded(y_folded: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor | None, scale: int,
                               in_fold: int) -> torch.Tensor:
    """SAME HR conv applied to a pre-``depth_to_space(in_fold)`` NHWC
    tensor: equals ``conv_subpixel_space(depth_to_space(y_folded,
    in_fold), w, b, scale)`` and never forms the HR tensor."""
    kernel, padding, stride = partial_fold_kernel(
        w.to(y_folded.dtype), scale, in_fold)
    r2 = scale * scale
    bias = None if b is None else b.to(y_folded.dtype).repeat_interleave(r2)
    out = _conv_nhwc(y_folded, kernel, bias, stride, padding)
    return depth_to_space(out, scale)
