"""Residual dense block (RDB): CUDA kernels and plain versions.

``fused_rdb`` is the PyTorch counterpart of the JAX package's
``torchsr_tpu/ops/pallas/rdb.py`` ``fused_rdb`` (its TPU kernels
``_rdb_fwd_kernel``, rdb.py:142, and ``_rdb_bwd_kernel``, rdb.py:495),
with the same layouts: NHWC activations (B, H, W, 64), five HWIO kernels
(3, 3, C_in, C_out) with C_in = 64 + 32 i, and five biases.  It computes
``x + scale_ratio * conv5(dense(x))``, where ``dense`` grows the
64-channel input by 32 LeakyReLU(0.2) channels per conv.

It is differentiable through ``_FusedRDB``, a ``torch.autograd.Function``
whose saved residual is the forward's post-activation (B, H, W, 192)
feature buffer (x, then the four grown slices), as the JAX custom VJP
saves it.  A CUDA tensor runs the hand-written kernels: ``csrc/rdb_fwd.cu``
(in bf16 the six launches of ``csrc/rdb_fwd_sm90.cuh``, a prep and five
convs with the TPU kernel's kx-packed product, the three horizontal taps
along N and reduced on the results: ``rdb_fwd_kxpack_reference`` is that
data flow in plain PyTorch; in f32 the same data flow in the six
launches of ``csrc/rdb_fwd_tf32_sm90.cuh``, each product taken as three
TF32 ones on the tensor cores (3xTF32: ``rdb_fwd_3xtf32_reference`` is
that arithmetic), whatever ``torch.backends``' TF32 switches say) and,
in the backward,
``csrc/rdb_bwd.cu``: in bf16 the eight launches of
``csrc/rdb_bwd_sm90.cuh``, where each slot's dense gradient is one conv
over the later convs' cotangents, held in one working-dtype buffer DY
(``rdb_bwd_dy_reference`` is that data flow in plain PyTorch); in f32
the same data flow in the eight launches of ``csrc/rdb_bwd_tf32_sm90.cuh``,
each product taken as three TF32 ones (``rdb_bwd_3xtf32_reference`` is
that arithmetic; design and bound in the headers).  A CPU tensor runs
the plain versions, ``rdb_reference``
and ``rdb_bwd_reference``, through the same Function.  There is no
fallback: on CUDA the kernel runs or the call raises.  A forward that no
backward follows (grad mode off, or nothing requires grad) runs the same
kernels as the operator ``torchsr_tpu_torch::rdb_fwd`` (``rdb_fwd_op``),
which has a fake implementation, so that ``torch.export`` traces it into
a serving artifact (``infer/serving.py``); ``plain_forward`` makes every
block its plain version instead, for an artifact that is pure aten.

Two layout variants of the JAX package are selected by the same
environment knobs, read once at import (``EXT_KERNEL``, ``ILV_KERNEL``;
a test may flip the module flags):

* ``TORCHSR_RDB_EXT=1``: on shapes ``_ext_eligible`` admits, forward and
  backward run on a row-extended buffer (B, H + 2, W, 192) with a zero
  pad row above and below each image (``csrc/rdb_ext.cu``, for the TPU
  kernels ``_rdb_fwd_kernel_ext`` :299 and ``_rdb_bwd_kernel_ext`` :594);
  plain versions ``rdb_ext_reference`` / ``rdb_bwd_ext_reference``.
* ``TORCHSR_RDB_ILV=1``: a forward that no backward follows, and that
  the ext variant did not take, runs on a chunk-interleaved buffer
  (B*H*W, 576) (``csrc/rdb_ilv.cu``, for ``_rdb_fwd_kernel_ilv`` :223;
  in f32 the 3xTF32 kernels of ``csrc/rdb_ilv_tf32_sm90.cuh``); plain
  version ``rdb_ilv_reference``, ``rdb_ilv_runs_reference`` with the
  bf16 kernels' data flow (runs of 128 pixels, three stores) and
  ``rdb_ilv_3xtf32_reference`` with the f32 kernels' arithmetic.

The backward takes its variant from what the forward saved, never from
the knobs.  ``TORCHSR_RDB_BWD=xla`` (``BWD_XLA``), the JAX package's
gradient-debugging backend, runs every backward as ``rdb_bwd_reference``
from the saved buffer instead of a kernel.

Precision (the TPU kernels' contract): products take working-dtype
operands (bf16 under AMP, else f32; the f32 forward takes each f32
product as three TF32 ones, ~2^-21 of it lost, the order of an f32
FMA's rounding; the f32 backward likewise) and accumulate in f32;
biases, dW, db and every sum stay f32; dx and the cotangents dy_i are
stored in the working dtype.  The weight
gradients reach the f32 parameters in f32, never rounded through bf16.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import os

import torch
import torch.nn.functional as F

CHANNELS = 64
GROWTH = 32
CIN = (64, 96, 128, 160, 192)
COUT = (32, 32, 32, 32, 64)
FEAT = CIN[-1]

# Kernel launches by the forward on CUDA: five per block (its five
# convs; the prep launch is not counted), in bf16 here and in f32 (the
# 3xTF32 kernels) in RDB_FWD_F32_LAUNCHES.  A run reads them to show
# that its path went through the kernel.
RDB_FWD_LAUNCHES = 0
RDB_FWD_F32_LAUNCHES = 0
# Block backwards run by the backward kernels on CUDA: one per block
# backward (eight launches of csrc/rdb_bwd.cu), in bf16 here and in f32
# (the 3xTF32 kernels) in RDB_BWD_F32_LAUNCHES.
RDB_BWD_LAUNCHES = 0
RDB_BWD_F32_LAUNCHES = 0
# The row-extended forward (five launches per block; f32 in
# RDB_FWD_EXT_F32_LAUNCHES) and backward (one per block backward, eight
# launches; f32 in RDB_BWD_EXT_F32_LAUNCHES), and the interleaved forward
# (five conv launches per block, its prep not counted; f32, the 3xTF32
# kernels, in RDB_FWD_ILV_F32_LAUNCHES).
RDB_FWD_EXT_LAUNCHES = 0
RDB_FWD_EXT_F32_LAUNCHES = 0
RDB_BWD_EXT_LAUNCHES = 0
RDB_BWD_EXT_F32_LAUNCHES = 0
RDB_FWD_ILV_LAUNCHES = 0
RDB_FWD_ILV_F32_LAUNCHES = 0
# Block backwards run on CUDA by the TORCHSR_RDB_BWD=xla backend
# (rdb_bwd_reference, no kernel); 0 on every default path.
RDB_BWD_XLA_LAUNCHES = 0
# Every counter above, by name (train/graphs.py adds a captured step's
# share of each once per replay).
LAUNCH_COUNTERS = ("RDB_FWD_LAUNCHES", "RDB_FWD_F32_LAUNCHES",
                   "RDB_BWD_LAUNCHES", "RDB_BWD_F32_LAUNCHES",
                   "RDB_FWD_EXT_LAUNCHES", "RDB_FWD_EXT_F32_LAUNCHES",
                   "RDB_BWD_EXT_LAUNCHES", "RDB_BWD_EXT_F32_LAUNCHES",
                   "RDB_FWD_ILV_LAUNCHES", "RDB_FWD_ILV_F32_LAUNCHES",
                   "RDB_BWD_XLA_LAUNCHES")

# The JAX package's knobs, names and defaults (torchsr_tpu/ops/pallas/
# rdb.py:386, :403, :753), read once at import.
EXT_KERNEL = os.environ.get("TORCHSR_RDB_EXT", "0") == "1"
ILV_KERNEL = os.environ.get("TORCHSR_RDB_ILV", "0") == "1"
BWD_XLA = os.environ.get("TORCHSR_RDB_BWD", "pallas") == "xla"
# The JAX package's single-image row cap (rdb.py:68), which its ext gate
# reads.
_MAX_IMAGE_ROWS = 4096
# The JAX package's ext gate admits widths that are multiples of 16.
_EXT_TILE_W = 16

_DTYPES = (torch.float32, torch.bfloat16)
# The backward kernels count a call's buffer pixels (B * H * W, or B * (H
# + 2) * W row-extended) in 32-bit ints (prep blocks, runs).
_MAX_BWD_PIXELS = 2**31 - 1
# Buffer pixels summed into one partial of db_4 by a bf16 prep block
# (csrc/rdb_bwd_sm90.cuh PREP_PIXELS: 256 blocks at the training shape,
# two an SM), and image pixels by an f32 one (rdb_bwd_tf32_sm90.cuh:
# image pixels, so that B8's partials are B2's)
_BWD_PREP_PIXELS = 256
_BWD_TF32_PREP_PIXELS = 256
# The bf16 backward's schedule (csrc/rdb_bwd_sm90.cuh): runs of up to
# _BWD_RUN output pixels of one image, across row ends where W <=
# _BWD_NARROW_W, else inside one row (ops/pair_conv.py's runs).  Each slot
# conv takes min(runs, _BWD_CTAS) persistent CTAs (one per SM: its stages
# take 208 KB), CTA c walking runs c, c + grid, ..., each run's K chunks
# of 64 DY channels in order; dx's two 32-channel halves take half as
# many each.  The wgrad's seven tiles take min(runs, _BWD_WGRAD_CTAS)
# CTAs each (126 in all).  A halo stage holds _BWD_HALO_MAX pixels.
_BWD_RUN = 128
_BWD_NARROW_W = 64
_BWD_HALO_MAX = 392
_BWD_CTAS = 132
_BWD_WGRAD_TILES = 7
_BWD_WGRAD_CTAS = 18
# Slot s's first DY channel and K chunks (slots 0-3: conv s's output
# slot; 4, 5: dx's halves), and the packed weights (bf16 elements)
_BWD_SLOT_K0 = (32, 64, 96, 128, 0, 0)
_BWD_SLOT_CHUNKS = tuple(-(-(FEAT - k0) // 64) for k0 in _BWD_SLOT_K0)
_BWD_WPACK = sum(_BWD_SLOT_CHUNKS) * 9 * GROWTH * 64
# Shared memory of a slot conv CTA (1024 alignment slack, three chunks of
# weights, two halo stages, the db exchange) and of a wgrad CTA (slack,
# two stages of feat halo and DY run); the H100's per-block limit
_BWD_CONV_SMEM = (1024 + 3 * 9 * GROWTH * 128 + 2 * _BWD_HALO_MAX * 128
                  + 1024)
_BWD_WGRAD_SMEM = 1024 + 2 * (_BWD_HALO_MAX * 128 + _BWD_RUN * 128)
SMEM_LIMIT = 232448
# Each library's one entry of the bf16 backward
_BWD_BF16_ENTRY = {"rdb_bwd": "rdb_bwd_bf16_launch",
                   "rdb_ext": "rdb_ext_bwd_bf16_launch"}
# The f32 backward (3xTF32, csrc/rdb_bwd_tf32_sm90.cuh; mirrored by
# bwd_tf32_schedule): slot convs on the f32 forward's runs, ring and
# grids (slot j as convs 1-4, dx's halves as conv 5's), K chunks of 32
# DY channels from slot_k0, chunk 0 first; the prep's hi and lo planes of
# the flipped, transposed kernels (f32 elements: per chunk 3 ky x 2 x 96
# x 32, 26 chunks as the forward's); the wgrad on the same runs and the
# bf16 wgrad's seven 64 x 64 tiles and partials, min(runs,
# _BWD_TF32_WGRAD_CTAS) CTAs for each tile and ky (the three taps of one
# ky a CTA), two stages of two halo boxes (the run's rows, box_h - 2 of
# them, 32 channels) and of DY^T's hi and lo planes (4 x 64 rows of 128
# bytes each).
_BWD_TF32_SLOT_CHUNKS = tuple((FEAT - k0) // 32 for k0 in _BWD_SLOT_K0)
_BWD_TF32_WPACK = sum(_BWD_TF32_SLOT_CHUNKS) * 3 * 2 * 3 * GROWTH * 32
_BWD_TF32_WGRAD_CTAS = 6
_BWD_TF32_GT_PLANE = 4 * CHANNELS * 128
_BWD_TF32_ENTRY = {"rdb_bwd": "rdb_bwd_tf32_launch",
                   "rdb_ext": "rdb_ext_bwd_tf32_launch"}
# The bf16 forward's schedule, as the launches compute it
# (csrc/rdb_fwd_sm90.cuh; mirrored here for the plain emulation and the
# tests, held against the kernel's own on the card): a run has at most
# _FWD_M y rows (two warpgroups).  Where W <= _FWD_NARROW_W it is _FWD_M
# // W whole image rows, its y rows its pixels; else up to _FWD_M - 2
# pixels inside one row (a row's runs of equal length), its y rows its
# pixels and one beyond each end.  Convs 1-4 take min(runs, _FWD_CTAS)
# persistent CTAs (one per SM), conv 5's two halves half as many each;
# CTA c walks runs c, c + grid, ..., each run's K chunks of 64 feat
# channels from the last to the first.  A run's halo (its rows and the
# rows above and below) is one TMA box of fixed size, a ring stage holds
# one, and a conv's ring as many stages as fit beside its packed weights
# and the output tile, at most _FWD_MAX_STAGES.
_FWD_M = 128
_FWD_NARROW_W = 64
_FWD_CTAS = 132
_FWD_MAX_STAGES = 4
# Slot s (convs 1-4, then conv 5's two 32-channel halves): K chunks, and
# the packed weights (bf16 elements: per chunk, 3 ky x 96 x 64)
_FWD_SLOT_CHUNKS = tuple(-(-ci // 64) for ci in (*CIN, CIN[4]))
_FWD_WPACK = sum(_FWD_SLOT_CHUNKS) * 3 * 3 * GROWTH * 64
# Dynamic shared memory of a conv CTA: the H100's per-block limit less
# its static (the epilogues' boundary rows, 4 KB; the ring's mbarriers); the
# output tile of each of its two warpgroups (_FWD_M pixels x 32 bf16)
_FWD_SMEM_DYN = 232448 - 4352
_FWD_OUT_TILE = _FWD_M * 64
# The interleaved bf16 forward's schedule (csrc/rdb_ilv.cu ilv_sm90;
# mirrored by ilv_schedule): a run is _ILV_RUN consecutive pixels of the
# (B*H*W, 576) buffer, m0 - 1 .. m0 + _ILV_OUTS, m0 = _ILV_OUTS t, its
# outputs m0 .. m0 + _ILV_OUTS - 1.  Convs 1-4 take min(runs, _ILV_CTAS)
# persistent CTAs, conv 5's two halves half as many each; CTA c walks runs
# c, c + grid, ..., each run's K stages of 64 prefix columns in order (the
# last of convs 2 and 4 holds 32).  A ring stage holds one K stage of a run
# (_ILV_RUN rows of 128 bytes); a conv's ring as many as fit beside its
# packed weights (a K stage: 96 rows of 128 bytes) and its two
# warpgroups' output tiles (one each), at most _ILV_MAX_STAGES.
_ILV_RUN = 128
_ILV_OUTS = _ILV_RUN - 2
_ILV_CTAS = 132
_ILV_MAX_STAGES = 8
_ILV_SMEM_DYN = 232448 - 4608
_ILV_OUT_TILE = _ILV_RUN * 64
_ILV_SLOT_KST = tuple(-(-3 * ci // 64) for ci in (*CIN, CIN[4]))
# packed weights (bf16 elements): 96 rows of each slot's 3 C_in
_ILV_WPACK = 3 * GROWTH * 3 * (sum(CIN) + CIN[4])
# Each library's one entry of the bf16 forward, and its packed weights
_FWD_BF16_ENTRY = {"rdb_fwd": "rdb_fwd_bf16_launch",
                   "rdb_ext": "rdb_ext_fwd_bf16_launch",
                   "rdb_ilv": "rdb_ilv_bf16_launch"}
_FWD_BF16_WPACK = {"rdb_fwd": _FWD_WPACK, "rdb_ext": _FWD_WPACK,
                   "rdb_ilv": _ILV_WPACK}
# The f32 forward (3xTF32, csrc/rdb_fwd_tf32_sm90.cuh; mirrored by
# fwd_tf32_schedule): the bf16 forward's runs, except that a run inside a
# row has at most _FWD_TF32_WIDE_M y rows; K chunks of _FWD_TF32_KC
# channels (a 128-byte f32 row), chunk 0 first; a ring item is one
# chunk of one run, its halo box (rounded up to 1024 bytes) and the
# chunk's hi and lo weight planes (3 ky x 2 x 96 rows x 128 bytes); the
# ring holds as many items as fit, at most _FWD_MAX_STAGES.  Grids as in
# bf16.
_FWD_TF32_WIDE_M = 96
_FWD_TF32_KC = 32
_FWD_TF32_W_CHUNK = 3 * 2 * 3 * GROWTH * 128
_FWD_TF32_SLOT_CHUNKS = tuple(ci // _FWD_TF32_KC for ci in (*CIN, CIN[4]))
# the prep's hi and lo planes (f32 elements)
_FWD_TF32_WPACK = sum(_FWD_TF32_SLOT_CHUNKS) * _FWD_TF32_W_CHUNK // 4
_FWD_TF32_ENTRY = {"rdb_fwd": "rdb_fwd_tf32_launch",
                   "rdb_ext": "rdb_ext_fwd_tf32_launch",
                   "rdb_ilv": "rdb_ilv_tf32_launch"}
# The interleaved f32 forward (3xTF32, csrc/rdb_ilv_tf32_sm90.cuh;
# mirrored by ilv_tf32_schedule): bf16's runs and grids; a K stage is
# _ILV_TF32_KC prefix columns (a 128-byte f32 row), one (chunk, dy) of
# the repack_ilv order, taken in order; a ring item is one K stage of
# one run, its box (_ILV_RUN rows of 128 bytes) and the stage's hi and lo
# weight planes (2 x 96 rows of 128 bytes: the f32 slot forward's planes
# of chunk kk // 3, ky kk % 3); the ring holds as many items as fit, at
# most _ILV_MAX_STAGES.  The tensor core's accumulation chain is added
# into f32 sums after each _ILV_TF32_CHAIN prefix columns (a chunk).
_ILV_TF32_KC = 32
_ILV_TF32_CHAIN = 96
_ILV_TF32_STAGE = _ILV_RUN * 128 + 2 * 3 * GROWTH * 128
_ILV_TF32_SLOT_KST = tuple(3 * ci // _ILV_TF32_KC for ci in (*CIN, CIN[4]))
_ILV_TF32_STAGES = min(_ILV_MAX_STAGES,
                       (_FWD_SMEM_DYN - 1024) // _ILV_TF32_STAGE)


def _check_kernels(kernels) -> None:
    if len(kernels) != 5:
        raise ValueError("fused_rdb expects five kernels and five biases")
    for i, k in enumerate(kernels):
        if tuple(k.shape) != (3, 3, CIN[i], COUT[i]):
            raise ValueError(
                f"kernel {i + 1} must be HWIO (3, 3, {CIN[i]}, "
                f"{COUT[i]}), got {tuple(k.shape)}"
            )


def _check(x: torch.Tensor, kernels, biases) -> None:
    if x.dim() != 4 or x.shape[-1] != CHANNELS:
        raise ValueError(
            f"fused_rdb expects NHWC x of shape (B, H, W, {CHANNELS}), "
            f"got {tuple(x.shape)}"
        )
    if len(biases) != 5:
        raise ValueError("fused_rdb expects five kernels and five biases")
    _check_kernels(kernels)
    for i, b in enumerate(biases):
        if tuple(b.shape) != (COUT[i],):
            raise ValueError(
                f"bias {i + 1} must be ({COUT[i]},), got {tuple(b.shape)}"
            )


def _ext_eligible(hw: int, width: int) -> bool:
    """The JAX package's gate for the row-extended kernels (rdb.py:406):
    the knob, an image of at most 4096 pixels, and a width that is a
    multiple of 16."""
    return EXT_KERNEL and hw <= _MAX_IMAGE_ROWS and width % 16 == 0


def _variant(x: torch.Tensor, params) -> str:
    """The kernel variant the JAX package's ``_rdb_fwd`` (:444-445)
    picks for this call: ``"ext"`` when the knob is set and the shape is
    eligible; else ``"ilv"`` when ILV is set and no backward will follow
    (grad mode off, or nothing requires grad); else ``"slot"`` (B1/B2)."""
    _, h, w, _ = x.shape
    if _ext_eligible(h * w, w):
        return "ext"
    grad_follows = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in params))
    return "ilv" if ILV_KERNEL and not grad_follows else "slot"


def pack_kernel(k: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Ci, Co) -> the packed GEMM weight (3 Ci, 3 Co): row
    (dy, ci), column (dx, co), as the JAX package's ``pack_kernel``."""
    ky, kx, ci, co = k.shape
    return k.permute(0, 2, 1, 3).reshape(ky * ci, kx * co)


def unpack_kernel(packed: torch.Tensor, ci: int, co: int) -> torch.Tensor:
    """Inverse of :func:`pack_kernel`: (3 Ci, 3 Co) -> HWIO."""
    return packed.reshape(3, ci, 3, co).permute(0, 2, 1, 3)


def pack_kernel_t(k: torch.Tensor) -> torch.Tensor:
    """HWIO -> the transposed packed weight (3 Co, 3 Ci): row (dx, co),
    column (dy, ci), the backward's operand."""
    ky, kx, ci, co = k.shape
    return k.permute(1, 3, 0, 2).reshape(kx * co, ky * ci)


def repack_ilv(w: torch.Tensor, ci: int) -> torch.Tensor:
    """Packed weight (rows (dy, ci)) -> chunk-interleaved rows (chunk,
    dy, ci within the chunk); columns (dx, co) unchanged.  The JAX
    package's ``_repack_ilv`` (rdb.py:291), element for element."""
    r, c3 = w.shape
    t = w.reshape(3, ci // GROWTH, GROWTH, c3)
    return t.permute(1, 0, 2, 3).reshape(r, c3)


def _reduce_taps(y: torch.Tensor, cout: int) -> torch.Tensor:
    """The horizontal-tap reduction of a packed product y (B, H, W,
    3 Co): out[x] = y[x - 1, dx 0] + y[x, dx 1] + y[x + 1, dx 2], the
    neighbours outside the row dropped (first_col / last_col)."""
    left = F.pad(y[:, :, :-1, :cout], (0, 0, 1, 0))
    right = F.pad(y[:, :, 1:, 2 * cout:], (0, 0, 0, 1))
    return left + y[..., cout:2 * cout] + right


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """Products of working-dtype operands summed in f32 (f64 for f64)."""
    return torch.promote_types(dt, torch.float32)


def rdb_ext_reference(x: torch.Tensor, kernels, biases,
                      scale_ratio: float = 0.2):
    """The plain version of the row-extended forward, with the data flow
    of ``_rdb_fwd_kernel_ext`` (rdb.py:299), the TPU kernel's kx-packed
    product (``_rdb_fwd_kernel``, rdb.py:186-206): the features of each
    image live once in a (H + 2, W, 192) buffer between two zero pad
    rows; per conv and vertical tap ky, one product of the row-offset
    view ky of it with W[ky] as (C_in, 3 C_out), the three horizontal
    taps packed along N; the taps reduced on the results with the column
    masks (``_reduce_taps``), then the bias; LeakyReLU and one rounding
    into the buffer's data rows (convs 1-4, the 32 new channels appended
    with one store), or x + scale * conv5 rounded once.  Operands in
    ``x.dtype``, sums in f32 (f64 for f64).  Returns the block output and
    the (B, H + 2, W, 192) buffer."""
    _check(x, kernels, biases)
    dt, acc = x.dtype, _acc_dtype(x.dtype)
    b, h, w, _ = x.shape
    buf = x.new_zeros((b, h + 2, w, FEAT))
    buf[:, 1:h + 1, :, :CHANNELS] = x
    out = None
    for i, (cin, cout) in enumerate(zip(CIN, COUT)):
        wp = pack_kernel(kernels[i].to(dt)).to(acc)
        y = sum(buf[:, s:s + h, :, :cin].to(acc) @ wp[s * cin:(s + 1) * cin]
                for s in range(3))
        out = _reduce_taps(y, cout) + biases[i].to(acc)
        if i < 4:
            buf[:, 1:h + 1, :, cin:cin + GROWTH] = F.leaky_relu(out, 0.2).to(dt)
    return (out * scale_ratio + x.to(acc)).to(dt), buf


def rdb_fwd_kxpack_reference(x: torch.Tensor, kernels, biases,
                             scale_ratio: float = 0.2):
    """The plain version of the bf16 forward kernels' data flow
    (``csrc/rdb_fwd_sm90.cuh``), B1's as B7's: ``rdb_ext_reference``'s
    kx-packed product, its buffer's data rows as the (B, H, W, 192)
    feature buffer.  Returns the block output and that buffer."""
    out, buf = rdb_ext_reference(x, kernels, biases, scale_ratio)
    return out, buf[:, 1:-1].contiguous()


def rdb_bwd_ext_reference(g: torch.Tensor, feat_padded: torch.Tensor,
                          kernels, scale_ratio: float = 0.2, *,
                          return_dfeat: bool = False):
    """The plain version of the row-extended backward, with the data
    flow of ``_rdb_bwd_kernel_ext`` (rdb.py:594): ``feat_padded`` is the
    forward's (B, H + 2, W, 192) buffer; dW reads its three row-offset
    views; dx3 = dy @ W^T is added into a padded f32 dense gradient
    (B, H + 2, W, 192) at row offsets 0, 1, 2 with no shifts or masks
    (what falls outside the image lands in the pad rows and is never
    read).  Returns ``(dx, dws, dbs)`` as :func:`rdb_bwd_reference` does
    (and the padded dense gradient with ``return_dfeat``)."""
    if feat_padded.dim() != 4 or feat_padded.shape[-1] != FEAT:
        raise ValueError(
            f"feat_padded must be (B, H + 2, W, {FEAT}), got "
            f"{tuple(feat_padded.shape)}")
    b, hp, w, _ = feat_padded.shape
    h = hp - 2
    if tuple(g.shape) != (b, h, w, CHANNELS):
        raise ValueError(
            f"g must be ({b}, {h}, {w}, {CHANNELS}) beside feat_padded "
            f"{tuple(feat_padded.shape)}, got {tuple(g.shape)}")
    _check_kernels(kernels)
    dt, acc = feat_padded.dtype, _acc_dtype(feat_padded.dtype)
    f = feat_padded.to(acc)
    dfeat = f.new_zeros((b, hp, w, FEAT))
    g32 = g.to(acc)
    da = g32 * scale_ratio
    dws, dbs = [None] * 5, [None] * 5
    for i in reversed(range(5)):
        cin, cout = CIN[i], COUT[i]
        dbs[i] = da.sum(dim=(0, 1, 2))
        # the transpose of the tap reduction: dy_0[x] = da[x + 1] (zero
        # on the last column), dy_2[x] = da[x - 1] (zero on the first)
        dy = torch.cat([F.pad(da[:, :, 1:], (0, 0, 0, 1)), da,
                        F.pad(da[:, :, :-1], (0, 0, 1, 0))], dim=-1)
        dy = dy.to(dt).to(acc).reshape(-1, 3 * cout)
        dws[i] = unpack_kernel(torch.cat(
            [f[:, s:s + h, :, :cin].reshape(-1, cin).T @ dy
             for s in range(3)]), cin, cout)
        dx3 = (dy @ pack_kernel_t(kernels[i].to(dt)).to(acc)).reshape(
            b, h, w, 3 * cin)
        for s in range(3):
            dfeat[:, s:s + h, :, :cin] += dx3[..., s * cin:(s + 1) * cin]
        if i > 0:
            sl = _slot(i - 1)
            da = dfeat[:, 1:h + 1, :, sl] * (
                0.2 + 0.8 * (f[:, 1:h + 1, :, sl] > 0).to(acc))
    dx = (dfeat[:, 1:h + 1, :, :CHANNELS] + g32).to(g.dtype)
    out = (dx.contiguous(), tuple(dws), tuple(dbs))
    return (*out, dfeat) if return_dfeat else out


def ilv_columns(chunk: int, part: int) -> slice:
    """Columns of the interleaved buffer holding 32-channel chunk
    ``chunk``'s copy ``part`` (0: up, the row above; 1: mid; 2: dn, the
    row below)."""
    lo = chunk * 3 * GROWTH + part * GROWTH
    return slice(lo, lo + GROWTH)


def rdb_ilv_reference(x: torch.Tensor, kernels, biases,
                      scale_ratio: float = 0.2):
    """The plain version of the interleaved forward, with the data flow
    of ``_rdb_fwd_kernel_ilv`` (rdb.py:223): a (B, H, W, 576) buffer
    whose 32-channel chunk j holds [up | mid | dn] (the chunk at the row
    above, at the pixel, at the row below; zeros past the image's top
    and bottom); each conv is one product of the contiguous 3 C_in
    prefix with the ``repack_ilv`` weight, the taps reduced with the
    column masks.  Operands in ``x.dtype``, sums in f32.  Returns the
    block output and the buffer."""
    _check(x, kernels, biases)
    dt, acc = x.dtype, _acc_dtype(x.dtype)
    b, h, w, _ = x.shape
    buf = x.new_zeros((b, h, w, 3 * FEAT))
    _ilv_grow(buf, x, 0)
    out = None
    for i, (cin, cout) in enumerate(zip(CIN, COUT)):
        wi = repack_ilv(pack_kernel(kernels[i].to(dt)), cin).to(acc)
        out = _reduce_taps(buf[..., :3 * cin].to(acc) @ wi, cout) + \
            biases[i].to(acc)
        if i < 4:
            _ilv_grow(buf, F.leaky_relu(out, 0.2).to(dt), cin // GROWTH)
    return (out * scale_ratio + x.to(acc)).to(dt), buf


def _ilv_grow(buf: torch.Tensor, v: torch.Tensor, chunk0: int) -> None:
    """Store NHWC ``v``'s 32-channel chunks as chunks ``chunk0`` ... of the
    interleaved ``buf``: [up | mid | dn], the rows above and below (zeros
    past the image's top and bottom)."""
    up = F.pad(v[:, :-1], (0, 0, 0, 0, 1, 0))
    dn = F.pad(v[:, 1:], (0, 0, 0, 0, 0, 1))
    for j in range(v.shape[-1] // GROWTH):
        sl = slice(j * GROWTH, (j + 1) * GROWTH)
        for part, src in enumerate((up, v, dn)):
            buf[..., ilv_columns(chunk0 + j, part)] = src[..., sl]


def _slot(i: int) -> slice:
    """Channels of the feature buffer that conv ``i`` (0-based, i < 4)
    appends."""
    lo = CHANNELS + GROWTH * i
    return slice(lo, lo + GROWTH)


def _rdb_plain(x: torch.Tensor, kernels, biases, scale_ratio: float):
    """The plain forward: five ``F.conv2d`` calls on the concatenated
    features, in ``x.dtype``.  Returns the block output and the NHWC
    feature buffer (x, then the four post-activation slices)."""
    _check(x, kernels, biases)
    dt = x.dtype
    xc = x.permute(0, 3, 1, 2)
    feats = [xc]
    out = xc
    for i in range(5):
        w = kernels[i].permute(3, 2, 0, 1).to(dt)
        out = F.conv2d(torch.cat(feats, dim=1), w, biases[i].to(dt),
                       padding=1)
        if i < 4:
            feats.append(F.leaky_relu(out, 0.2))
    out = (out * scale_ratio + xc).permute(0, 2, 3, 1).contiguous()
    return out, torch.cat(feats, dim=1).permute(0, 2, 3, 1)


def rdb_reference(
    x: torch.Tensor, kernels, biases, *, scale_ratio: float = 0.2
) -> torch.Tensor:
    """The plain version: five ``F.conv2d`` calls on the concatenated
    features, computed in ``x.dtype`` (the unfused flax block's math)."""
    return _rdb_plain(x, kernels, biases, scale_ratio)[0]


def rdb_bwd_reference(
    g: torch.Tensor, feat: torch.Tensor, kernels, scale_ratio: float = 0.2,
    *, return_dfeat: bool = False,
):
    """The plain backward of the block from its output cotangent ``g``
    (B, H, W, 64) and the forward's feature buffer ``feat`` (B, H, W,
    192), mirroring the JAX package's ``_rdb_bwd_xla`` (rdb.py:756).

    Each conv is reversed in ``torch.nn.grad.conv2d_input`` /
    ``conv2d_weight``: the operands are rounded to ``feat.dtype`` (the
    working dtype) and multiplied in f32 (f64 for f64 inputs), so the
    products accumulate in f32; the LeakyReLU derivative is read from
    the post-activation sign.  Returns ``(dx, dws, dbs)``: dx in
    ``g.dtype``, five HWIO dW and five db in that accumulation dtype
    (and the (B, H, W, 192) dense gradient with ``return_dfeat``)."""
    if feat.dim() != 4 or feat.shape[-1] != FEAT:
        raise ValueError(
            f"feat must be NHWC (B, H, W, {FEAT}), got {tuple(feat.shape)}"
        )
    if tuple(g.shape) != (*feat.shape[:3], CHANNELS):
        raise ValueError(
            f"g must be (B, H, W, {CHANNELS}) beside feat "
            f"{tuple(feat.shape)}, got {tuple(g.shape)}"
        )
    dt = feat.dtype
    acc = torch.promote_types(dt, torch.float32)
    f = feat.permute(0, 3, 1, 2).to(acc)
    g32 = g.permute(0, 3, 1, 2).to(acc)
    dfeat = torch.zeros_like(f)
    da = g32 * scale_ratio
    dws, dbs = [None] * 5, [None] * 5
    for i in reversed(range(5)):
        cin = CIN[i]
        dy = da.to(dt).to(acc)
        w = kernels[i].to(dt).to(acc).permute(3, 2, 0, 1)  # OIHW
        dbs[i] = da.sum(dim=(0, 2, 3))
        dws[i] = torch.nn.grad.conv2d_weight(
            f[:, :cin], w.shape, dy, padding=1).permute(2, 3, 1, 0)
        dfeat[:, :cin] += torch.nn.grad.conv2d_input(
            f[:, :cin].shape, w, dy, padding=1)
        if i > 0:
            s = _slot(i - 1)
            da = dfeat[:, s] * (0.2 + 0.8 * (f[:, s] > 0).to(acc))
    dx = (dfeat[:, :CHANNELS] + g32).to(g.dtype).permute(0, 2, 3, 1)
    out = (dx.contiguous(), tuple(dws), tuple(dbs))
    if return_dfeat:
        return (*out, dfeat.permute(0, 2, 3, 1).contiguous())
    return out


def _slot_weight(kernels, ci0: int, k0: int, dt, acc) -> torch.Tensor:
    """The OIHW weight of one slot conv: output channels ci0 .. ci0 + n of
    feat, input channels DY[k0:] (dy_k of conv k, k0 at a conv's first
    cotangent channel), taps flipped: weight[n][d][ky][kx] = K_k[2 - ky]
    [2 - kx][ci0 + n][co]."""
    n = CHANNELS if ci0 == 0 else GROWTH
    return torch.cat(
        [kernels[k].to(dt).to(acc).flip(0, 1)[:, :, ci0:ci0 + n]
         .permute(2, 3, 0, 1) for k in range(min(k0 // GROWTH, 4), 5)],
        dim=1)


def rdb_bwd_dy_reference(
    g: torch.Tensor, feat: torch.Tensor, kernels, scale_ratio: float = 0.2,
    *, padded: bool = False,
):
    """The plain version of the bf16 backward kernels' data flow
    (``csrc/rdb_bwd_sm90.cuh``).  Every cotangent goes into one buffer DY
    = [dy_0 | dy_1 | dy_2 | dy_3 | dy_4] (192 channels, ``feat.dtype``):
    dy_4 = round(scale * g); then, for slot j = 3..0, one conv of the
    suffix DY[:, 32 (j + 1):] with the flipped kernels of convs j + 1..4
    gives slot j's dense gradient, da_j = that * LeakyReLU'(feat's slot
    j) and dy_j = round(da_j); dx = round(the conv of all of DY onto
    feat's first 64 channels + g).  dW_i sums feat's windows times dy_i;
    db_i sums da_i (f32, unrounded).  Operands in ``feat.dtype``, sums in
    f32 (f64 for f64).  ``padded``: ``feat`` is the row-extended (B, H +
    2, W, 192) buffer and DY comes back in that layout, its pad rows zero.
    Returns ``(dx, dws, dbs, dy)``."""
    if padded:
        dx, dws, dbs, dy = rdb_bwd_dy_reference(g, feat[:, 1:-1], kernels,
                                                scale_ratio)
        return dx, dws, dbs, F.pad(dy, (0, 0, 0, 0, 1, 1))
    if feat.dim() != 4 or feat.shape[-1] != FEAT:
        raise ValueError(
            f"feat must be NHWC (B, H, W, {FEAT}), got {tuple(feat.shape)}")
    if tuple(g.shape) != (*feat.shape[:3], CHANNELS):
        raise ValueError(
            f"g must be (B, H, W, {CHANNELS}) beside feat "
            f"{tuple(feat.shape)}, got {tuple(g.shape)}")
    _check_kernels(kernels)
    dt, acc = feat.dtype, _acc_dtype(feat.dtype)
    f = feat.permute(0, 3, 1, 2).to(acc)
    dy = torch.zeros_like(f)
    das = [None] * 5
    das[4] = g.permute(0, 3, 1, 2).to(acc) * scale_ratio
    dy[:, 4 * GROWTH:] = das[4].to(dt).to(acc)
    for j in reversed(range(4)):
        k0, s = GROWTH * (j + 1), _slot(j)
        w = _slot_weight(kernels, s.start, k0, dt, acc)
        das[j] = F.conv2d(dy[:, k0:], w, padding=1) * (
            0.2 + 0.8 * (f[:, s] > 0).to(acc))
        dy[:, GROWTH * j:k0] = das[j].to(dt).to(acc)
    dx = F.conv2d(dy, _slot_weight(kernels, 0, 0, dt, acc), padding=1)
    dx = (dx + g.permute(0, 3, 1, 2).to(acc)).to(g.dtype)
    dws, dbs = [], []
    for i, (cin, cout) in enumerate(zip(CIN, COUT)):
        lo = GROWTH * i
        dws.append(torch.nn.grad.conv2d_weight(
            f[:, :cin], (cout, cin, 3, 3), dy[:, lo:lo + cout],
            padding=1).permute(2, 3, 1, 0))
        dbs.append(das[i].sum(dim=(0, 2, 3)))
    return (dx.permute(0, 2, 3, 1).contiguous(), tuple(dws), tuple(dbs),
            dy.to(dt).permute(0, 2, 3, 1).contiguous())


class _FusedRDB(torch.autograd.Function):
    """The block with its feature buffer as the saved residual; kernels
    on CUDA, plain versions on the CPU.  ``variant`` (``_variant``) picks
    the layout; the backward reads it from ``ctx``."""

    @staticmethod
    def forward(ctx, x, scale_ratio, variant, *params):
        kernels, biases = params[:5], params[5:]
        cuda = x.device.type == "cuda"
        feat = None
        if variant == "ext":
            out, feat = (rdb_fwd_ext_cuda if cuda else rdb_ext_reference)(
                x, kernels, biases, scale_ratio=scale_ratio)
        elif variant == "ilv":
            out, _ = (rdb_fwd_ilv_cuda if cuda else rdb_ilv_reference)(
                x, kernels, biases, scale_ratio=scale_ratio)
        elif cuda:
            out, feat = rdb_fwd_cuda(x, kernels, biases,
                                     scale_ratio=scale_ratio)
        else:
            out, feat = _rdb_plain(x, kernels, biases, scale_ratio)
        ctx.scale_ratio = scale_ratio
        ctx.variant = variant
        if feat is not None and any(ctx.needs_input_grad):
            ctx.save_for_backward(feat, *kernels)
        return out

    @staticmethod
    def backward(ctx, g):
        global RDB_BWD_XLA_LAUNCHES
        if ctx.variant == "ilv":
            raise RuntimeError(
                "the interleaved RDB forward saves nothing to differentiate"
            )
        feat, *kernels = ctx.saved_tensors
        scale, ext = ctx.scale_ratio, ctx.variant == "ext"
        if BWD_XLA:
            if feat.device.type == "cuda":
                RDB_BWD_XLA_LAUNCHES += 1
            dx, dws, dbs = rdb_bwd_reference(
                g.to(feat.dtype), feat[:, 1:-1] if ext else feat, kernels,
                scale)
        elif feat.device.type == "cuda":
            dx, dws, dbs, _ = (rdb_bwd_ext_cuda if ext else rdb_bwd_cuda)(
                g, feat, kernels, scale_ratio=scale)
        else:
            dx, dws, dbs = (rdb_bwd_ext_reference if ext
                            else rdb_bwd_reference)(
                g.to(feat.dtype), feat, kernels, scale)
        dws = [dw.to(k.dtype) for dw, k in zip(dws, kernels)]
        return (dx, None, None, *dws, *dbs)


def fused_rdb(
    x: torch.Tensor, kernels, biases, *, scale_ratio: float = 0.2
) -> torch.Tensor:
    """Residual dense block ``x + scale_ratio * conv5(dense(x))``.

    ``x``: (B, H, W, 64) NHWC, f32 or bf16.  ``kernels``: five HWIO
    (3, 3, C_in, C_out) kernels; ``biases``: five (C_out,) vectors.  On
    CUDA the kernels are used in ``x.dtype`` and the biases in f32.
    Differentiable in x, the kernels and the biases (``_FusedRDB``);
    where no backward follows it calls ``rdb_fwd_op``.  The layout
    variant follows the knobs (module docstring, ``_variant``)."""
    kernels, biases = tuple(kernels), tuple(biases)
    _check(x, kernels, biases)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"fused_rdb runs on CUDA (kernel) or CPU (plain version), "
            f"not on {x.device}"
        )
    if _PLAIN.get():
        return rdb_reference(x, kernels, biases, scale_ratio=scale_ratio)
    variant = _variant(x, (*kernels, *biases))
    grad_follows = torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in (*kernels, *biases)))
    if not grad_follows:
        return torch.ops.torchsr_tpu_torch.rdb_fwd(
            x, list(kernels), list(biases), float(scale_ratio), variant)
    return _FusedRDB.apply(x, float(scale_ratio), variant, *kernels,
                           *biases)


# ``plain_forward`` sets it (in its own thread and context only): every
# ``fused_rdb`` runs ``rdb_reference``, and every ``ops.bn_act.bn_act``
# its module composition.
_PLAIN = contextvars.ContextVar("torchsr_rdb_plain", default=False)


@contextlib.contextmanager
def plain_forward():
    """Within the block every model kernel is its plain version (a
    ``fused_rdb`` five ``F.conv2d`` calls, a ``bn_act`` the BatchNorm
    module and its epilogue): what a portable (pure aten) export
    traces."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


@torch.library.custom_op("torchsr_tpu_torch::rdb_fwd", mutates_args=())
def rdb_fwd_op(x: torch.Tensor, kernels: list[torch.Tensor],
               biases: list[torch.Tensor], scale_ratio: float,
               variant: str) -> torch.Tensor:
    """The inference forward as an operator (``torchsr_tpu_torch::
    rdb_fwd``), the path of every ``fused_rdb`` no backward follows, so
    that ``torch.export`` can trace it (``register_fake``) and an
    exported program calls it.  On CUDA it launches the kernel of
    ``variant`` (``"slot"`` B1, ``"ext"`` B7, ``"ilv"`` B6) or raises;
    on the CPU it runs that variant's plain version."""
    if x.device.type == "cuda":
        fwd = {"ext": rdb_fwd_ext_cuda, "ilv": rdb_fwd_ilv_cuda}.get(
            variant, rdb_fwd_cuda)
        return fwd(x, kernels, biases, scale_ratio=scale_ratio)[0]
    if variant == "ext":
        return rdb_ext_reference(x, kernels, biases,
                                 scale_ratio=scale_ratio)[0]
    if variant == "ilv":
        return rdb_ilv_reference(x, kernels, biases,
                                 scale_ratio=scale_ratio)[0]
    return _rdb_plain(x, kernels, biases, scale_ratio)[0]


@rdb_fwd_op.register_fake
def _rdb_fwd_fake(x, kernels, biases, scale_ratio, variant):
    _check(x, kernels, biases)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _cuda_operands(x: torch.Tensor, tensors, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA, not on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, not {x.dtype}")
    for t in tensors:
        if t.device != x.device:
            raise ValueError(
                f"{what} operands must share {x.device}, got one on "
                f"{t.device}"
            )


def _aligned(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous, at a 16-byte aligned address (the
    kernels read weights in 16-byte vectors)."""
    t = t.to(dtype).contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _raise_on(err: int, error_string, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} failed to launch: CUDA error {err} "
            f"({error_string(err).decode()})"
        )


def rdb_fwd_cuda(
    x: torch.Tensor, kernels, biases, *, scale_ratio: float = 0.2
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel path of the forward on a CUDA ``x``.  Returns the
    block output and the (B, H, W, 192) feature buffer the launches
    filled (x, then the four grown 32-channel slices), so that each
    conv can be held against its own convolution, and the backward can
    start from it.  The kernels go to the kernel as they are (f32, or in
    bf16 also bf16; any strides); f32 runs 3xTF32 on the tensor cores,
    whatever ``torch.backends``' TF32 switches say."""
    global RDB_FWD_LAUNCHES, RDB_FWD_F32_LAUNCHES
    kernels, biases = tuple(kernels), tuple(biases)
    _check(x, kernels, biases)
    _cuda_operands(x, (*kernels, *biases), "rdb_fwd_cuda")
    x = x.contiguous()
    b, h, w, _ = x.shape
    feat = torch.empty((b, h, w, FEAT), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _fwd_launch("rdb_fwd", x, kernels, biases, scale_ratio, feat, out)
    if x.dtype == torch.float32:
        RDB_FWD_F32_LAUNCHES += 5
    else:
        RDB_FWD_LAUNCHES += 5
    return out, feat


def _fwd_box(w: int, wide_m: int = _FWD_M) -> tuple:
    """The forward's halo box at width w: (box_w, box_h) pixels; a run
    inside a row has at most ``wide_m`` y rows (bf16: ``_FWD_M``, f32:
    ``_FWD_TF32_WIDE_M``)."""
    if w <= _FWD_NARROW_W:
        return w, _FWD_M // w + 2
    nx = -(-w // (wide_m - 2))
    return -(-w // nx) + 2, 3


def fwd_runs(b: int, h: int, w: int, wide_m: int = _FWD_M) -> list:
    """The forward's runs, as its kernels count them (``run_of`` in
    ``csrc/rdb_fwd_sm90.cuh``, and with ``wide_m=_FWD_TF32_WIDE_M`` in
    ``csrc/rdb_fwd_tf32_sm90.cuh``): ``(img, p0, n, e, r0, hx0, hw)``
    each.  Output pixels p0 .. p0 + n - 1 of image img (y * W + x); y row
    m (0 .. n + 2 e - 1) is pixel p0 - e + m, its A row for tap ky the
    box pixel m + ky hw; the halo box (hw pixels a row) starts at image
    pixel (r0 - 1, hx0)."""
    hw = _fwd_box(w, wide_m)[0]
    runs = []
    for img in range(b):
        if w <= _FWD_NARROW_W:
            rows = _FWD_M // w
            for r0 in range(0, h, rows):
                runs.append((img, r0 * w, min(rows, h - r0) * w, 0, r0, 0,
                             hw))
        else:
            length = hw - 2
            for y in range(h):
                for x0 in range(0, w, length):
                    runs.append((img, y * w + x0, min(length, w - x0), 1, y,
                                 x0 - 1, hw))
    return runs


def _fwd_grid(b: int, h: int, w: int, wide_m: int) -> tuple:
    """What the two forwards' schedules share (``FwdRuns`` in
    ``csrc/rdb_mma.cuh``): their runs, persistent grids (``conv_ctas``
    for each of convs 1-4, ``c5_ctas`` for each of conv 5's two halves)
    and halo box (pixels), and the box's bytes rounded up to a swizzle
    atom."""
    runs = b * (-(-h // (_FWD_M // w)) if w <= _FWD_NARROW_W
                else h * -(-w // (wide_m - 2)))
    bw, bh = _fwd_box(w, wide_m)
    return ({"runs": runs, "conv_ctas": max(1, min(runs, _FWD_CTAS)),
             "c5_ctas": max(1, min(runs, _FWD_CTAS // 2)), "box": (bw, bh)},
            -(-bw * bh * 128 // 1024) * 1024)


def _fwd_walk(sched: dict, slot: int, chunks) -> list:
    """The (run, K chunk) items each CTA of slot ``slot``'s conv takes
    under ``sched``, the chunks of a run in the order ``chunks``."""
    ctas = sched["conv_ctas" if slot < 4 else "c5_ctas"]
    return [[(t, c) for t in range(cta, sched["runs"], ctas)
             for c in chunks] for cta in range(ctas)]


@functools.cache
def fwd_schedule(b: int, h: int, w: int) -> dict:
    """The bf16 forward's persistent grids, halo box (pixels) and ring
    stage (bytes) and, per slot, its stages and dynamic shared memory
    (bytes): a mirror of what the launches compute (``fwd_schedule_of``
    in ``csrc/rdb_fwd_sm90.cuh``; the card's smoke test holds it against
    :func:`fwd_kernel_schedule`)."""
    grid, stage = _fwd_grid(b, h, w, _FWD_M)
    weights = [nch * 3 * 3 * GROWTH * 128 for nch in _FWD_SLOT_CHUNKS]
    stages = [min(_FWD_MAX_STAGES,
                  (_FWD_SMEM_DYN - 1024 - 2 * _FWD_OUT_TILE - wb) // stage)
              for wb in weights]
    return {**grid, "stage_bytes": stage, "stages": tuple(stages),
            "smem": tuple(1024 + wb + 2 * _FWD_OUT_TILE + n * stage
                          for wb, n in zip(weights, stages))}


def fwd_kernel_schedule(b: int, h: int, w: int) -> dict:
    """The schedule the bf16 forward's launches run at (b, h, w), as the
    built library reports it (``rdb_fwd_bf16_schedule``), in the form of
    :func:`fwd_schedule`, which mirrors it."""
    import ctypes

    from torchsr_tpu_torch.ops._build import load_library

    v = (ctypes.c_int * 18)()
    load_library("rdb_fwd").rdb_fwd_bf16_schedule(b, h, w, v)
    return {"runs": v[0], "conv_ctas": v[1], "c5_ctas": v[2],
            "box": (v[3], v[4]), "stage_bytes": v[5],
            "stages": tuple(v[6:12]), "smem": tuple(v[12:18])}


def fwd_walk(b: int, h: int, w: int, slot: int) -> list:
    """The (run, K chunk) items each CTA of slot ``slot``'s conv takes, in
    order (chunk 0 last): one list per CTA (conv 5's halves, slots 4 and
    5, one grid each)."""
    return _fwd_walk(fwd_schedule(b, h, w), slot,
                     range(_FWD_SLOT_CHUNKS[slot] - 1, -1, -1))


@functools.cache
def fwd_tf32_schedule(b: int, h: int, w: int) -> dict:
    """The f32 forward's persistent grids, halo box (pixels), ring stage
    and its halo (bytes), ring stages and dynamic shared memory (bytes):
    a mirror of what its launches compute (``fwd_schedule_of`` in
    ``csrc/rdb_fwd_tf32_sm90.cuh``; the card's smoke test holds it
    against :func:`fwd_tf32_kernel_schedule`)."""
    grid, halo = _fwd_grid(b, h, w, _FWD_TF32_WIDE_M)
    stage = halo + _FWD_TF32_W_CHUNK
    stages = min(_FWD_MAX_STAGES, (_FWD_SMEM_DYN - 1024) // stage)
    return {**grid, "stage_bytes": stage, "halo_bytes": halo,
            "stages": stages, "smem": 1024 + stages * stage}


def fwd_tf32_kernel_schedule(b: int, h: int, w: int) -> dict:
    """The schedule the f32 forward's launches run at (b, h, w), as the
    built library reports it (``rdb_fwd_tf32_schedule``), in the form of
    :func:`fwd_tf32_schedule`, which mirrors it."""
    import ctypes

    from torchsr_tpu_torch.ops._build import load_library

    v = (ctypes.c_int * 9)()
    load_library("rdb_fwd").rdb_fwd_tf32_schedule(b, h, w, v)
    return {"runs": v[0], "conv_ctas": v[1], "c5_ctas": v[2],
            "box": (v[3], v[4]), "stage_bytes": v[5], "halo_bytes": v[6],
            "stages": v[7], "smem": v[8]}


def fwd_tf32_walk(b: int, h: int, w: int, slot: int) -> list:
    """The (run, K chunk) items each CTA of slot ``slot``'s f32 conv
    takes, in order (chunk 0 first): one list per CTA."""
    return _fwd_walk(fwd_tf32_schedule(b, h, w), slot,
                     range(_FWD_TF32_SLOT_CHUNKS[slot]))


def _fwd_slot(s: int) -> tuple:
    """Slot s of the bf16 forward: its conv, input channels and first
    output channel (convs 1-4, then conv 5's two 32-channel halves)."""
    i = min(s, 4)
    return i, CIN[i], GROWTH if s == 5 else 0


def fwd_pack_weights(kernels) -> torch.Tensor:
    """The five HWIO kernels rounded to bf16 and packed as the bf16
    forward's prep launch writes them (``rdb_fwd_prep``): per slot, per
    K chunk c of 64 channels, per ky, 96 rows (kx * 32 + co) of 64
    columns (input channel 64 c + k, zero past C_in), the order in which
    the conv CTAs stage them."""
    parts = []
    for s, nch in enumerate(_FWD_SLOT_CHUNKS):
        i, cin, co0 = _fwd_slot(s)
        k = kernels[i].to(torch.bfloat16)[..., co0:co0 + GROWTH]
        k = F.pad(k, (0, 0, 0, 64 * nch - cin))
        parts.append(k.reshape(3, 3, nch, 64, GROWTH).permute(2, 0, 1, 4, 3)
                     .reshape(-1))
    return torch.cat(parts)


def fwd_unpack_weights(packed: torch.Tensor) -> tuple:
    """Inverse of :func:`fwd_pack_weights`: the five bf16 HWIO kernels."""
    halves, o = [], 0
    for s, nch in enumerate(_FWD_SLOT_CHUNKS):
        _, cin, _ = _fwd_slot(s)
        n = nch * 3 * 3 * GROWTH * 64
        halves.append(packed[o:o + n].view(nch, 3, 3, GROWTH, 64)
                      .permute(1, 2, 0, 4, 3).reshape(3, 3, 64 * nch, GROWTH)
                      [:, :, :cin])
        o += n
    return (*halves[:4], torch.cat(halves[4:], dim=-1))


def _swizzle128(rows: int) -> torch.Tensor:
    """Element order of a tile of ``rows`` rows of 32 f32 in the 128-byte
    swizzle: entry i is the element (row i // 32, k i % 32) that float i
    of the tile holds (16-byte chunk c of row n at chunk c ^ (n % 8))."""
    n = torch.arange(rows).view(rows, 1, 1)
    c = torch.arange(8).view(1, 8, 1)
    e = torch.arange(4).view(1, 1, 4)
    return (n * 32 + (c ^ (n % 8)) * 4 + e).reshape(-1)


def fwd_tf32_pack_weights(kernels) -> torch.Tensor:
    """The five HWIO kernels split into TF32 hi and lo planes as the f32
    forward's prep launch writes them (``rdb_fwd_tf32_prep``): per slot,
    per K chunk c of 32 channels, per ky, a hi plane then a lo plane of
    96 rows (kx * 32 + co) of 32 columns (input channel 32 c + k) in the
    128-byte swizzle, the order in which the conv CTAs stage them.  lo is
    the exact f32 rest (hi + lo is the weight)."""
    from torchsr_tpu_torch.ops.tf32 import tf32_split

    order = _swizzle128(3 * GROWTH)
    parts = []
    for s, nch in enumerate(_FWD_TF32_SLOT_CHUNKS):
        i, _, co0 = _fwd_slot(s)
        k = kernels[i].float()[..., co0:co0 + GROWTH]
        hi = tf32_split(k)[0]
        # (chunk, ky, row kx * 32 + co, k)
        planes = [t.reshape(3, 3, nch, _FWD_TF32_KC, GROWTH)
                  .permute(2, 0, 1, 4, 3).reshape(nch, 3, -1)
                  for t in (hi, k - hi)]
        parts.append(torch.stack(planes, dim=2)[..., order].reshape(-1))
    return torch.cat(parts)


def fwd_tf32_unpack_weights(packed: torch.Tensor) -> tuple:
    """Inverse of :func:`fwd_tf32_pack_weights`: the five HWIO kernels as
    hi + lo."""
    inverse = torch.argsort(_swizzle128(3 * GROWTH))
    halves, o = [], 0
    for nch in _FWD_TF32_SLOT_CHUNKS:
        n = nch * _FWD_TF32_W_CHUNK // 4
        t = packed[o:o + n].view(nch, 3, 2, -1)[..., inverse]
        t = (t[:, :, 0] + t[:, :, 1]).view(nch, 3, 3, GROWTH, _FWD_TF32_KC)
        halves.append(t.permute(1, 2, 0, 4, 3).reshape(3, 3, -1, GROWTH))
        o += n
    return (*halves[:4], torch.cat(halves[4:], dim=-1))


def rdb_fwd_3xtf32_reference(x: torch.Tensor, kernels, biases,
                             scale_ratio: float = 0.2, *, terms=None,
                             padded: bool = False):
    """The f32 forward kernels' arithmetic in plain PyTorch (3xTF32,
    ``csrc/rdb_fwd_tf32_sm90.cuh``): per conv, the f32 convs of the TF32
    parts (``ops/tf32.py`` ``tf32_split``) of the feature buffer's C_in
    prefix (A, split where the kernel splits it, in registers) and of
    the kernel (B, the prep's planes) that ``terms`` names, summed in the
    kernel's order (``TF32_TERMS``, the default: hi.lo, lo.hi, hi.hi;
    fewer terms: a wrong kernel), then the bias; LeakyReLU into the
    buffer's slot (convs 1-4) or x + scale * conv5.  Returns the block
    output and the (B, H, W, 192) feature buffer, or with ``padded`` the
    row-extended (B, H + 2, W, 192) one with zero pad rows (B7's)."""
    from torchsr_tpu_torch.ops.tf32 import TF32_TERMS, tf32_parts

    _check(x, kernels, biases)
    terms = TF32_TERMS if terms is None else terms
    xf = x.float()
    b, h, w, _ = x.shape
    feat = xf.new_zeros((b, h, w, FEAT))
    feat[..., :CHANNELS] = xf
    acc = None
    for i, (cin, cout) in enumerate(zip(CIN, COUT)):
        fs = tf32_parts(feat[..., :cin].permute(0, 3, 1, 2))
        ks = tf32_parts(kernels[i].float().permute(3, 2, 0, 1))
        acc = sum(F.conv2d(fs[a], ks[k], padding=1) for a, k in terms)
        acc = (acc + biases[i].float().view(1, cout, 1, 1)).permute(
            0, 2, 3, 1)
        if i < 4:
            feat[..., cin:cin + cout] = F.leaky_relu(acc, 0.2)
    out = (acc * scale_ratio + xf).contiguous()
    if padded:
        feat = F.pad(feat, (0, 0, 0, 0, 1, 1))
    return out, feat


def _weight_args(kernels):
    """The five kernels as the forward's and the bf16 backward's entries
    take them: f32 as they are (any strides), else in bf16.  Returns the tensors (keep them alive
    over the call), ctypes arrays of their pointers and (ky, kx, ci, co)
    strides, and whether they are f32."""
    import ctypes

    w_f32 = all(k.dtype == torch.float32 for k in kernels)
    if not w_f32:
        kernels = [k.to(torch.bfloat16) for k in kernels]
    ptrs = (ctypes.c_void_p * 5)(*(k.data_ptr() for k in kernels))
    strides = (ctypes.c_longlong * 20)(*(s for k in kernels
                                         for s in k.stride()))
    return kernels, ptrs, strides, w_f32


def _fwd_launch(lib_name, x, kernels, biases, scale_ratio, feat, out):
    """The forward's one entry in library ``lib_name`` for x's dtype
    (``rdb_fwd`` on the (B, H, W, 192) ``feat``, ``rdb_ext`` on the
    row-extended one, ``rdb_ilv`` on the interleaved (B, H, W, 576) one):
    a prep launch packs the kernels (in f32: splits them
    into TF32 hi and lo planes; and zeroes ``feat``'s pad rows, or
    writes x's chunks and the edge zeros into the interleaved buffer),
    five conv launches fill ``feat`` (B1's and B7's first copies x into
    it) and ``out``."""
    import ctypes

    from torchsr_tpu_torch.ops._build import load_library

    dev = x.device
    b, h, w, _ = x.shape
    f32 = x.dtype == torch.float32
    if f32:  # f32 as they are (any strides), a cast otherwise
        kernels = [k.float() for k in kernels]
    kernels, wptrs, wstrides, w_f32 = _weight_args(kernels)
    biases = [b_.to(torch.float32).contiguous() for b_ in biases]
    bptrs = (ctypes.c_void_p * 5)(*(b_.data_ptr() for b_ in biases))
    lib = load_library(lib_name)
    if f32:
        wpack = torch.empty(_FWD_TF32_WPACK, dtype=torch.float32, device=dev)
        entry = getattr(lib, _FWD_TF32_ENTRY[lib_name])
        flag = ()
    else:
        wpack = torch.empty(_FWD_BF16_WPACK[lib_name], dtype=torch.bfloat16,
                            device=dev)
        entry = getattr(lib, _FWD_BF16_ENTRY[lib_name])
        flag = (int(w_f32),)
    errstr = getattr(lib, "rdb_error_string" if lib_name == "rdb_fwd"
                     else f"{lib_name}_error_string")
    _raise_on(entry(
        x.data_ptr(), feat.data_ptr(), out.data_ptr(), ctypes.addressof(wptrs),
        ctypes.addressof(wstrides), *flag, ctypes.addressof(bptrs),
        wpack.data_ptr(), b, h, w, float(scale_ratio), dev.index,
        torch.cuda.current_stream(dev).cuda_stream), errstr,
        f"{lib_name} {'f32' if f32 else 'bf16'} forward")


def _bwd_shape(b: int, hp: int, w: int) -> None:
    if b * hp * w > _MAX_BWD_PIXELS:
        raise ValueError(
            f"the RDB backward takes at most {_MAX_BWD_PIXELS} buffer "
            f"pixels per call, got {b * hp * w}")


def rdb_bwd_cuda(
    g: torch.Tensor, feat: torch.Tensor, kernels, *,
    scale_ratio: float = 0.2,
):
    """The kernel path of the backward on CUDA.  ``g``: the (B, H, W,
    64) output cotangent; ``feat``: the forward's (B, H, W, 192) feature
    buffer in the working dtype; ``kernels``: the five HWIO kernels.

    Returns ``(dx, dws, dbs, dy)``: dx (B, H, W, 64) in ``feat.dtype``,
    five f32 HWIO dW, five f32 db, and DY, the (B, H, W, 192) buffer of
    every conv's cotangent [dy_0 | ... | dy_4] in ``feat.dtype``, so that
    each stage can be held against a plain computation of the kernel's
    own inputs.  f32 runs 3xTF32 on the tensor cores, whatever
    ``torch.backends``' TF32 switches say."""
    global RDB_BWD_LAUNCHES, RDB_BWD_F32_LAUNCHES
    kernels = tuple(kernels)
    if feat.dim() != 4 or feat.shape[-1] != FEAT:
        raise ValueError(
            f"feat must be NHWC (B, H, W, {FEAT}), got {tuple(feat.shape)}"
        )
    if tuple(g.shape) != (*feat.shape[:3], CHANNELS):
        raise ValueError(
            f"g must be (B, H, W, {CHANNELS}) beside feat "
            f"{tuple(feat.shape)}, got {tuple(g.shape)}"
        )
    _check_kernels(kernels)
    _cuda_operands(feat, (g, *kernels), "rdb_bwd_cuda")
    _bwd_shape(*feat.shape[:3])
    out = _bwd_launches("rdb_bwd", g, feat, kernels, scale_ratio)
    if feat.dtype == torch.float32:
        RDB_BWD_F32_LAUNCHES += 1
    else:
        RDB_BWD_LAUNCHES += 1
    return out


def bwd_schedule(b: int, h: int, w: int) -> dict:
    """The bf16 backward's persistent grids, as its kernels count the
    runs: ``conv_ctas`` for each slot conv, ``dx_ctas`` for each of dx's
    two halves, ``wgrad_ctas`` for each wgrad tile."""
    per = (-(-h * w // _BWD_RUN) if w <= _BWD_NARROW_W
           else h * -(-w // _BWD_RUN))
    runs = b * per
    return {"runs": runs, "conv_ctas": min(runs, _BWD_CTAS),
            "dx_ctas": min(runs, _BWD_CTAS // 2),
            "wgrad_ctas": min(runs, _BWD_WGRAD_CTAS)}


def bwd_walk(b: int, h: int, w: int, slot: int) -> list:
    """The (run, K chunk) items each CTA of slot ``slot``'s conv takes, in
    order: one list per CTA (dx's halves, slots 4 and 5, one grid each)."""
    sched = bwd_schedule(b, h, w)
    ctas = sched["conv_ctas" if slot < 4 else "dx_ctas"]
    nch = _BWD_SLOT_CHUNKS[slot]
    return [[(t, c) for t in range(cta, sched["runs"], ctas)
             for c in range(nch)] for cta in range(ctas)]


@functools.cache
def bwd_tf32_schedule(b: int, h: int, w: int) -> dict:
    """The f32 backward's persistent grids and buffers at (b, h, w): its
    slot convs' runs, grids (``conv_ctas`` each of slots 0-3,
    ``dx_ctas`` each of dx's halves), halo box, ring stage and stages and
    dynamic shared memory (the f32 forward's, ``fwd_tf32_schedule``);
    the wgrad's CTAs a tile (on the same runs) and shared memory; the
    prep's blocks of db_4 partials (``prep_blocks``).  A
    mirror of what the launches run (``bwd_schedule_of`` in
    ``csrc/rdb_bwd_tf32_sm90.cuh``; the card's smoke test holds it
    against :func:`bwd_tf32_kernel_schedule`)."""
    fwd = fwd_tf32_schedule(b, h, w)
    bw, bh = fwd["box"]
    return {"runs": fwd["runs"], "conv_ctas": fwd["conv_ctas"],
            "dx_ctas": fwd["c5_ctas"], "box": fwd["box"],
            "stage_bytes": fwd["stage_bytes"],
            "halo_bytes": fwd["halo_bytes"], "stages": fwd["stages"],
            "smem": fwd["smem"],
            "wgrad_ctas": min(fwd["runs"], _BWD_TF32_WGRAD_CTAS),
            "wgrad_smem": 1024 + 4 * _BWD_TF32_GT_PLANE + 4 * -(
                -bw * (bh - 2) * 128 // 1024) * 1024,
            "prep_blocks": -(-b * h * w // _BWD_TF32_PREP_PIXELS)}


def bwd_tf32_kernel_schedule(b: int, h: int, w: int) -> dict:
    """The schedule the f32 backward's launches run at (b, h, w), as the
    built library reports it (``rdb_bwd_tf32_schedule``), in the form of
    :func:`bwd_tf32_schedule` without ``prep_blocks`` (the wrapper's)."""
    import ctypes

    from torchsr_tpu_torch.ops._build import load_library

    v = (ctypes.c_int * 11)()
    load_library("rdb_bwd").rdb_bwd_tf32_schedule(b, h, w, v)
    return {"runs": v[0], "conv_ctas": v[1], "dx_ctas": v[2],
            "box": (v[3], v[4]), "stage_bytes": v[5], "halo_bytes": v[6],
            "stages": v[7], "smem": v[8], "wgrad_ctas": v[9],
            "wgrad_smem": v[10]}


def bwd_tf32_walk(b: int, h: int, w: int, slot: int) -> list:
    """The (run, K chunk) items each CTA of slot ``slot``'s f32 conv
    takes, in order (chunk 0 first): one list per CTA (dx's halves,
    slots 4 and 5, one grid each)."""
    sched = bwd_tf32_schedule(b, h, w)
    ctas = sched["conv_ctas" if slot < 4 else "dx_ctas"]
    return [[(t, c) for t in range(cta, sched["runs"], ctas)
             for c in range(_BWD_TF32_SLOT_CHUNKS[slot])]
            for cta in range(ctas)]


def _bwd_tf32_ci0(s: int) -> int:
    """Slot s's first output channel of feat (slots 0-3: conv s's output
    slot; 4, 5: dx's halves)."""
    return _BWD_SLOT_K0[s] + GROWTH if s < 4 else GROWTH * (s - 4)


def _bwd_tf32_slot_weight(kernels, s: int) -> torch.Tensor:
    """Slot s's kernel as the f32 backward's slot conv takes it: OIHW
    (32, 192 - k0, 3, 3), W'[n][d][ky][kx] = K_k[2 - ky][2 - kx][ci0 +
    n][co] for DY channel d = k0 + ... of conv k's cotangent channel co
    (``_slot_weight``'s 32 output channels from ci0)."""
    return _slot_weight(kernels, _bwd_tf32_ci0(s), _BWD_SLOT_K0[s],
                        torch.float32, torch.float32)[:GROWTH]


def bwd_tf32_pack_weights(kernels) -> torch.Tensor:
    """The five HWIO kernels flipped, transposed and split into TF32 hi
    and lo planes as the f32 backward's prep launch writes them
    (``rdb_bwd_tf32_prep``): per slot (slots 0-3, dx's two halves), per K
    chunk c of 32 DY channels, per ky, a hi plane then a lo plane of 96
    rows (kx * 32 + n) of 32 columns (DY channel k0 + 32 c + k) in the
    128-byte swizzle, the order in which the slot conv CTAs stage them;
    lo is the exact f32 rest."""
    from torchsr_tpu_torch.ops.tf32 import tf32_split

    order = _swizzle128(3 * GROWTH)
    parts = []
    for s, nch in enumerate(_BWD_TF32_SLOT_CHUNKS):
        wt = _bwd_tf32_slot_weight(kernels, s).permute(2, 3, 1, 0)
        hi = tf32_split(wt)[0]
        # (chunk, ky, row kx * 32 + n, k)
        planes = [t.reshape(3, 3, nch, 32, GROWTH).permute(2, 0, 1, 4, 3)
                  .reshape(nch, 3, -1) for t in (hi, wt - hi)]
        parts.append(torch.stack(planes, dim=2)[..., order].reshape(-1))
    return torch.cat(parts)


def bwd_tf32_unpack_weights(packed: torch.Tensor) -> tuple:
    """Inverse of :func:`bwd_tf32_pack_weights`: the five HWIO kernels as
    hi + lo (each element lies in the one slot whose output channels
    hold its C_in index)."""
    inverse = torch.argsort(_swizzle128(3 * GROWTH))
    ks = [packed.new_zeros((3, 3, ci, co)) for ci, co in zip(CIN, COUT)]
    o = 0
    for s, nch in enumerate(_BWD_TF32_SLOT_CHUNKS):
        n = nch * 3 * 2 * 3 * GROWTH * 32
        t = packed[o:o + n].view(nch, 3, 2, -1)[..., inverse]
        t = (t[:, :, 0] + t[:, :, 1]).view(nch, 3, 3, GROWTH, 32)
        wt = t.permute(1, 2, 0, 4, 3).reshape(3, 3, 32 * nch, GROWTH)
        ci0 = _bwd_tf32_ci0(s)
        d = 0
        for k in range(min(_BWD_SLOT_K0[s] // GROWTH, 4), 5):
            co = COUT[k]
            ks[k][:, :, ci0:ci0 + GROWTH] = wt[:, :, d:d + co].flip(
                0, 1).transpose(2, 3)
            d += co
        o += n
    return tuple(ks)


def rdb_bwd_3xtf32_reference(
    g: torch.Tensor, feat: torch.Tensor, kernels, scale_ratio: float = 0.2,
    *, terms=None, padded: bool = False,
):
    """The f32 backward kernels' arithmetic in plain PyTorch (3xTF32,
    ``csrc/rdb_bwd_tf32_sm90.cuh``), with the bf16 backward's data flow
    (``rdb_bwd_dy_reference``): dy_4 = scale g; for slot j = 3..0 the
    f32 convs of the TF32 parts (``ops/tf32.py`` ``tf32_parts``) of DY's
    suffix (A, split in registers) and of the slot's flipped kernels (B,
    the prep's planes) that ``terms`` names (``TF32_TERMS``, the default:
    hi.lo, lo.hi, hi.hi; fewer terms: a wrong kernel), times LeakyReLU',
    into DY unrounded; dx the same conv of all of DY plus g; dW_i the
    products of feat's parts (A) and dy_i's (B), db_i the f32 sum of
    da_i.  ``padded``: ``feat`` is the row-extended (B, H + 2, W, 192)
    buffer and DY comes back in that layout, its pad rows zero.  Returns
    ``(dx, dws, dbs, dy)`` in f32."""
    from torchsr_tpu_torch.ops.tf32 import TF32_TERMS, tf32_parts

    if padded:
        dx, dws, dbs, dy = rdb_bwd_3xtf32_reference(
            g, feat[:, 1:-1], kernels, scale_ratio, terms=terms)
        return dx, dws, dbs, F.pad(dy, (0, 0, 0, 0, 1, 1))
    if feat.dim() != 4 or feat.shape[-1] != FEAT:
        raise ValueError(
            f"feat must be NHWC (B, H, W, {FEAT}), got {tuple(feat.shape)}")
    if tuple(g.shape) != (*feat.shape[:3], CHANNELS):
        raise ValueError(
            f"g must be (B, H, W, {CHANNELS}) beside feat "
            f"{tuple(feat.shape)}, got {tuple(g.shape)}")
    _check_kernels(kernels)
    terms = TF32_TERMS if terms is None else terms
    f32 = torch.float32
    f = feat.permute(0, 3, 1, 2).float()
    g32 = g.permute(0, 3, 1, 2).float()
    dy = torch.zeros_like(f)

    def conv(src, s):
        xs, ws = tf32_parts(src), tf32_parts(_bwd_tf32_slot_weight(kernels,
                                                                   s))
        return sum(F.conv2d(xs[a], ws[b_], padding=1) for a, b_ in terms)

    das = [None] * 5
    das[4] = g32 * scale_ratio
    dy[:, 4 * GROWTH:] = das[4]
    for j in reversed(range(4)):
        sl = _slot(j)
        das[j] = conv(dy[:, _BWD_SLOT_K0[j]:], j) * (
            0.2 + 0.8 * (f[:, sl] > 0).to(f32))
        dy[:, GROWTH * j:GROWTH * (j + 1)] = das[j]
    dx = torch.cat([conv(dy, 4), conv(dy, 5)], dim=1) + g32
    fs = tf32_parts(f)
    dws, dbs = [], []
    for i, (cin, cout) in enumerate(zip(CIN, COUT)):
        ds = tf32_parts(dy[:, GROWTH * i:GROWTH * i + cout])
        dws.append(sum(torch.nn.grad.conv2d_weight(
            fs[a][:, :cin], (cout, cin, 3, 3), ds[b_], padding=1)
            for a, b_ in terms).permute(2, 3, 1, 0))
        dbs.append(das[i].sum(dim=(0, 2, 3)))
    return (dx.permute(0, 2, 3, 1).contiguous(), tuple(dws), tuple(dbs),
            dy.permute(0, 2, 3, 1).contiguous())


def _bwd_launches(lib_name: str, g, feat, kernels, scale_ratio):
    """One block backward in library ``lib_name`` (``rdb_bwd`` on the (B,
    H, W, 192) ``feat``, or ``rdb_ext`` on the (B, H + 2, W, 192)
    row-extended one), into DY shaped like ``feat``: one call of the
    library's eight launches for the working dtype (``_bwd_bf16``, or
    ``_bwd_tf32`` in f32).  Returns ``(dx, dws, dbs, dy)``."""
    from torchsr_tpu_torch.ops._build import load_library

    dt, dev = feat.dtype, feat.device
    feat = feat.contiguous()
    g = _aligned(g, dt)
    b, h, w, _ = g.shape
    dx = torch.empty((b, h, w, CHANNELS), dtype=dt, device=dev)
    dy = torch.empty(feat.shape, dtype=dt, device=dev)
    lib = load_library(lib_name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dt == torch.bfloat16:
        npix = feat.numel() // FEAT
        return _bwd_bf16(lib, lib_name, g, feat, kernels, scale_ratio, dx,
                         dy, -(-npix // _BWD_PREP_PIXELS), stream)
    return _bwd_tf32(lib, lib_name, g, feat, kernels, scale_ratio, dx, dy,
                     stream)


def _flat_grads(dw: torch.Tensor, db: torch.Tensor) -> tuple:
    """The five HWIO dW and five db, views of the flat outputs the
    backward entries write (dW conv by conv, db at 32 i)."""
    dws, o = [], 0
    for ci, co in zip(CIN, COUT):
        dws.append(dw[o:o + 9 * ci * co].view(3, 3, ci, co))
        o += 9 * ci * co
    return tuple(dws), tuple(db[GROWTH * i:GROWTH * i + co]
                             for i, co in enumerate(COUT))


def _bwd_tf32(lib, lib_name, g, feat, kernels, scale_ratio, dx, dy,
              stream):
    """The f32 backward's one entry: the kernels go as they are (f32,
    any strides; the prep launch flips and splits them), the scratch and
    the flat dW / db come from here, sized by ``bwd_tf32_schedule``."""
    import ctypes

    dev = feat.device
    b, h, w, _ = g.shape
    sched = bwd_tf32_schedule(b, h, w)
    parts = max(sched["prep_blocks"], sched["conv_ctas"])
    f32 = torch.float32
    kernels, ptrs, strides, _ = _weight_args([k.float() for k in kernels])
    wpack = torch.empty(_BWD_TF32_WPACK, dtype=f32, device=dev)
    dw_part = torch.empty((_BWD_WGRAD_TILES, sched["wgrad_ctas"], 9,
                           CHANNELS, CHANNELS), dtype=f32, device=dev)
    db_part = torch.empty((5, parts, CHANNELS), dtype=f32, device=dev)
    dw = torch.empty(sum(9 * ci * co for ci, co in zip(CIN, COUT)),
                     dtype=f32, device=dev)
    db = torch.empty(FEAT, dtype=f32, device=dev)
    entry = getattr(lib, _BWD_TF32_ENTRY[lib_name])
    _raise_on(entry(
        g.data_ptr(), feat.data_ptr(), ctypes.addressof(ptrs),
        ctypes.addressof(strides), dy.data_ptr(), dx.data_ptr(),
        wpack.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(),
        dw.data_ptr(), db.data_ptr(), b, h, w, float(scale_ratio),
        sched["prep_blocks"], parts, sched["conv_ctas"], sched["dx_ctas"],
        sched["wgrad_ctas"], dev.index, stream),
        getattr(lib, f"{lib_name}_error_string"), f"{lib_name} f32 backward")
    return (dx, *_flat_grads(dw, db), dy)


def _bwd_bf16(lib, lib_name, g, feat, kernels, scale_ratio, dx, dy,
              nblocks, stream):
    """The bf16 backward's one entry: the kernels go as they are (f32 or
    bf16, any strides; the prep launch rounds and packs them), the
    scratch and the flat dW / db come from here."""
    import ctypes

    dev = feat.device
    b, h, w, _ = g.shape
    sched = bwd_schedule(b, h, w)
    parts = max(nblocks, sched["conv_ctas"])
    f32 = torch.float32
    kernels, ptrs, strides, w_f32 = _weight_args(kernels)
    wpack = torch.empty(_BWD_WPACK, dtype=torch.bfloat16, device=dev)
    dw_part = torch.empty((_BWD_WGRAD_TILES, sched["wgrad_ctas"], 9,
                           CHANNELS, CHANNELS), dtype=f32, device=dev)
    db_part = torch.empty((5, parts, CHANNELS), dtype=f32, device=dev)
    dw = torch.empty(sum(9 * ci * co for ci, co in zip(CIN, COUT)),
                     dtype=f32, device=dev)
    db = torch.empty(FEAT, dtype=f32, device=dev)
    entry = getattr(lib, _BWD_BF16_ENTRY[lib_name])
    _raise_on(entry(
        g.data_ptr(), feat.data_ptr(), ctypes.addressof(ptrs),
        ctypes.addressof(strides), int(w_f32), dy.data_ptr(), dx.data_ptr(),
        wpack.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(),
        dw.data_ptr(), db.data_ptr(), b, h, w, float(scale_ratio), nblocks,
        parts, sched["conv_ctas"], sched["dx_ctas"], sched["wgrad_ctas"],
        dev.index, stream), getattr(lib, f"{lib_name}_error_string"),
        f"{lib_name} bf16 backward")
    return (dx, *_flat_grads(dw, db), dy)


def _ext_shape(b: int, h: int, w: int) -> None:
    if w % _EXT_TILE_W:
        raise ValueError(
            f"the row-extended RDB kernels take widths that are multiples "
            f"of {_EXT_TILE_W} (_ext_eligible), got {w}")


def rdb_fwd_ext_cuda(
    x: torch.Tensor, kernels, biases, *, scale_ratio: float = 0.2
) -> tuple[torch.Tensor, torch.Tensor]:
    """The row-extended forward on a CUDA ``x`` (``csrc/rdb_ext.cu``).
    Returns the block output and the (B, H + 2, W, 192) buffer the
    launches filled: x and the four grown slices on each image's data
    rows, the pad row above and below each image zero.  W must be a
    multiple of 16."""
    global RDB_FWD_EXT_LAUNCHES, RDB_FWD_EXT_F32_LAUNCHES
    kernels, biases = tuple(kernels), tuple(biases)
    _check(x, kernels, biases)
    _cuda_operands(x, (*kernels, *biases), "rdb_fwd_ext_cuda")
    b, h, w, _ = x.shape
    _ext_shape(b, h, w)
    x = x.contiguous()
    feat = torch.empty((b, h + 2, w, FEAT), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _fwd_launch("rdb_ext", x, kernels, biases, scale_ratio, feat, out)
    if x.dtype == torch.float32:
        RDB_FWD_EXT_F32_LAUNCHES += 5
    else:
        RDB_FWD_EXT_LAUNCHES += 5
    return out, feat


def rdb_bwd_ext_cuda(
    g: torch.Tensor, feat_padded: torch.Tensor, kernels, *,
    scale_ratio: float = 0.2,
):
    """The row-extended backward on CUDA (``csrc/rdb_ext.cu``).  ``g``:
    the (B, H, W, 64) output cotangent; ``feat_padded``: the (B, H + 2,
    W, 192) buffer of :func:`rdb_fwd_ext_cuda`; ``kernels``: the five
    HWIO kernels.

    Returns ``(dx, dws, dbs, dy)`` as :func:`rdb_bwd_cuda` does, with DY
    in the buffer's (B, H + 2, W, 192) layout, its pad rows zero."""
    global RDB_BWD_EXT_LAUNCHES, RDB_BWD_EXT_F32_LAUNCHES
    kernels = tuple(kernels)
    if feat_padded.dim() != 4 or feat_padded.shape[-1] != FEAT:
        raise ValueError(
            f"feat_padded must be (B, H + 2, W, {FEAT}), got "
            f"{tuple(feat_padded.shape)}")
    b, hp, w, _ = feat_padded.shape
    h = hp - 2
    if tuple(g.shape) != (b, h, w, CHANNELS):
        raise ValueError(
            f"g must be ({b}, {h}, {w}, {CHANNELS}) beside feat_padded "
            f"{tuple(feat_padded.shape)}, got {tuple(g.shape)}")
    _check_kernels(kernels)
    _cuda_operands(feat_padded, (g, *kernels), "rdb_bwd_ext_cuda")
    _ext_shape(b, h, w)
    _bwd_shape(b, hp, w)
    out = _bwd_launches("rdb_ext", g, feat_padded, kernels, scale_ratio)
    if feat_padded.dtype == torch.float32:
        RDB_BWD_EXT_F32_LAUNCHES += 1
    else:
        RDB_BWD_EXT_LAUNCHES += 1
    return out


def ilv_runs(b: int, h: int, w: int) -> list:
    """The interleaved bf16 forward's runs, as its kernels count them:
    ``(m0, n)`` each, the outputs m0 .. m0 + n - 1 of the (B*H*W, 576)
    buffer, computed from its pixels m0 - 1 .. m0 + 126 (zeros past the
    buffer's ends)."""
    m = b * h * w
    return [(m0, min(_ILV_OUTS, m - m0)) for m0 in range(0, m, _ILV_OUTS)]


@functools.cache
def ilv_schedule(b: int, h: int, w: int) -> dict:
    """The interleaved bf16 forward's persistent grids (``conv_ctas`` for
    each of convs 1-4, ``c5_ctas`` for each of conv 5's halves) and, per
    slot, its K stages, ring stages and dynamic shared memory (bytes): a
    mirror of what the launches compute (``schedule_of`` in
    ``csrc/rdb_ilv.cu``; the card's smoke test holds it against
    :func:`ilv_kernel_schedule`)."""
    runs = -(-(b * h * w) // _ILV_OUTS)
    fixed = [1024 + 2 * 3 * GROWTH * 3 * ci + 2 * _ILV_OUT_TILE
             for ci in (*CIN, CIN[4])]
    ring = tuple(min(_ILV_MAX_STAGES, (_ILV_SMEM_DYN - f) // (_ILV_RUN * 128))
                 for f in fixed)
    return {"runs": runs, "conv_ctas": max(1, min(runs, _ILV_CTAS)),
            "c5_ctas": max(1, min(runs, _ILV_CTAS // 2)),
            "kstages": _ILV_SLOT_KST, "ring": ring,
            "smem": tuple(f + n * _ILV_RUN * 128
                          for f, n in zip(fixed, ring))}


def ilv_kernel_schedule(b: int, h: int, w: int) -> dict:
    """The schedule the interleaved bf16 forward's launches run at (b, h,
    w), as the built library reports it (``rdb_ilv_bf16_schedule``), in
    the form of :func:`ilv_schedule`, which mirrors it."""
    import ctypes

    from torchsr_tpu_torch.ops._build import load_library

    v = (ctypes.c_int * 21)()
    load_library("rdb_ilv").rdb_ilv_bf16_schedule(b, h, w, v)
    return {"runs": v[0], "conv_ctas": v[1], "c5_ctas": v[2],
            "kstages": tuple(v[3:9]), "ring": tuple(v[9:15]),
            "smem": tuple(v[15:21])}


def ilv_walk(b: int, h: int, w: int, slot: int) -> list:
    """The (run, K stage) items each CTA of slot ``slot``'s conv takes, in
    order: one list per CTA (conv 5's halves, slots 4 and 5, one grid
    each, on the same items)."""
    return _fwd_walk(ilv_schedule(b, h, w), slot,
                     range(_ILV_SLOT_KST[slot]))


@functools.cache
def ilv_tf32_schedule(b: int, h: int, w: int) -> dict:
    """The interleaved f32 forward's persistent grids (as bf16's), ring
    item (bytes), ring stages, dynamic shared memory (bytes) and each
    slot's K stages of 32 prefix columns: a mirror of what its launches
    compute (``schedule_of`` in ``csrc/rdb_ilv_tf32_sm90.cuh``; the card's
    smoke test holds it against :func:`ilv_tf32_kernel_schedule`)."""
    runs = -(-(b * h * w) // _ILV_OUTS)
    return {"runs": runs, "conv_ctas": max(1, min(runs, _ILV_CTAS)),
            "c5_ctas": max(1, min(runs, _ILV_CTAS // 2)),
            "stage_bytes": _ILV_TF32_STAGE, "stages": _ILV_TF32_STAGES,
            "smem": 1024 + _ILV_TF32_STAGES * _ILV_TF32_STAGE,
            "chain_cols": _ILV_TF32_CHAIN, "kstages": _ILV_TF32_SLOT_KST}


def ilv_tf32_kernel_schedule(b: int, h: int, w: int) -> dict:
    """The schedule the interleaved f32 forward's launches run at (b, h,
    w), as the built library reports it (``rdb_ilv_tf32_schedule``), in
    the form of :func:`ilv_tf32_schedule`, which mirrors it."""
    import ctypes

    from torchsr_tpu_torch.ops._build import load_library

    v = (ctypes.c_int * 13)()
    load_library("rdb_ilv").rdb_ilv_tf32_schedule(b, h, w, v)
    return {"runs": v[0], "conv_ctas": v[1], "c5_ctas": v[2],
            "stage_bytes": v[3], "stages": v[4], "smem": v[5],
            "chain_cols": v[6], "kstages": tuple(v[7:13])}


def ilv_tf32_walk(b: int, h: int, w: int, slot: int) -> list:
    """The (run, K stage) items each CTA of slot ``slot``'s f32 conv takes,
    in order (a run's stages from the first): one list per CTA."""
    return _fwd_walk(ilv_tf32_schedule(b, h, w), slot,
                     range(_ILV_TF32_SLOT_KST[slot]))


def ilv_stores(b: int, h: int, w: int) -> dict:
    """What each conv of the interleaved forward (bf16 and f32 alike), and
    its prep, write
    into the buffer's slots of a grown chunk: ``{"mid", "up", "dn"}`` ->
    ``(dest, src)`` row tensors, one pair per element row written, where
    ``src`` is the pixel whose value lands at row ``dest`` (-1: a zero).
    Per run (:func:`ilv_runs`): its outputs' mid copies; their up copies
    at rows + W (zero from an image's last row; a run whose rows + W all
    fall past the buffer stores none); their dn copies at rows - W (zero
    from an image's first row; inside the buffer's first M - W rows).
    The prep: zeros over the up slots of the first W rows and the dn slots
    of the last W rows."""
    m = b * h * w
    p = torch.arange(m)
    y = p // w % h
    runs = [torch.arange(m0, m0 + n) for m0, n in ilv_runs(b, h, w)]
    mid = torch.cat(runs)
    up = torch.cat([r for r in runs if r[0] + w < m] or [p[:0]])
    up = up[up + w < m]
    dn = mid[(mid - w >= 0) & (mid - w < m - w)]
    edge = torch.arange(w)
    return {
        "mid": (mid, mid),
        "up": (torch.cat([edge, up + w]),
               torch.cat([torch.full((w,), -1),
                          torch.where(y[up] == h - 1, -1, up)])),
        "dn": (torch.cat([m - w + edge, dn - w]),
               torch.cat([torch.full((w,), -1),
                          torch.where(y[dn] == 0, -1, dn)])),
    }


def _ilv_swizzle(n: int, chunks: int) -> torch.Tensor:
    """Index of the 16-byte chunk stored at chunk d of row r of a swizzled
    tile of n rows of ``chunks`` chunks: d ^ (r % 8) in the 128-byte
    swizzle (8 chunks a row), d ^ ((r // 2) % 4) in the 64-byte one (4);
    an involution."""
    rows = torch.arange(n)[:, None]
    key = rows % 8 if chunks == 8 else rows // 2 % 4
    return torch.arange(chunks)[None, :] ^ key


def _ilv_stages(s: int):
    """(K stage, its first row, its rows) of slot s's packed weights: 64
    rows, or 32 for the last of convs 2 and 4."""
    k = 3 * _fwd_slot(s)[1]
    return [(kk, 64 * kk, min(64, k - 64 * kk))
            for kk in range(_ILV_SLOT_KST[s])]


def ilv_pack_weights(kernels) -> torch.Tensor:
    """The five HWIO kernels rounded to bf16 and packed as the interleaved
    bf16 forward's prep launch writes them: per slot (convs 1-4, then conv
    5's two 32-channel halves) the ``repack_ilv`` weight (rows (chunk, dy,
    ci), columns (dx, co) of the slot's channels), cut into K stages of 64
    rows (the last of convs 2 and 4: 32); each stage stored as 96 rows
    (one per column) of its K values, the 16-byte chunks of each row in
    the 128-byte swizzle (64-byte for a 32-row stage)."""
    parts = []
    for s in range(len(_ILV_SLOT_KST)):
        i, cin, co0 = _fwd_slot(s)
        k = kernels[i].to(torch.bfloat16)[..., co0:co0 + GROWTH]
        wi = repack_ilv(pack_kernel(k), cin)
        for _, r0, rows in _ilv_stages(s):
            t = wi[r0:r0 + rows].T.reshape(3 * GROWTH, rows // 8, 8)
            sw = _ilv_swizzle(3 * GROWTH, rows // 8)
            parts.append(t.gather(1, sw[:, :, None].expand_as(t))
                         .reshape(-1))
    return torch.cat(parts)


def ilv_unpack_weights(packed: torch.Tensor) -> tuple:
    """Inverse of :func:`ilv_pack_weights`: each conv's ``repack_ilv``
    weight (3 C_in, 3 C_out) in bf16."""
    halves, o = [], 0
    for s in range(len(_ILV_SLOT_KST)):
        stages = []
        for _, _, rows in _ilv_stages(s):
            n = 3 * GROWTH * rows
            t = packed[o:o + n].view(3 * GROWTH, rows // 8, 8)
            sw = _ilv_swizzle(3 * GROWTH, rows // 8)
            stages.append(t.gather(1, sw[:, :, None].expand_as(t))
                          .reshape(3 * GROWTH, rows).T)
            o += n
        halves.append(torch.cat(stages))
    return _ilv_conv5(halves)


def _ilv_conv5(halves: list) -> tuple:
    """Four convs' weights and conv 5's two 32-channel halves (3 C_in, 96)
    -> the five ``repack_ilv`` weights, conv 5's columns (dx, co)."""
    k = 3 * CIN[4]
    c5 = torch.cat([h.reshape(k, 3, GROWTH) for h in halves[4:]], dim=-1)
    return (*halves[:4], c5.reshape(k, 3 * COUT[4]))


def ilv_tf32_pack_weights(kernels) -> torch.Tensor:
    """The five HWIO kernels split into TF32 hi and lo planes as the
    interleaved f32 forward's prep writes them: K stage kk of a slot
    (``repack_ilv`` rows 32 kk .. 32 kk + 31: chunk kk // 3, dy kk % 3)
    is a hi plane then a lo plane of 96 rows (dx * 32 + co) of its 32 K
    values in the 128-byte swizzle.  These are the f32 slot forward's
    planes (:func:`fwd_tf32_pack_weights`: its chunk kk // 3, ky kk %
    3), the same floats in the same places."""
    return fwd_tf32_pack_weights(kernels)


def ilv_tf32_unpack_weights(packed: torch.Tensor) -> tuple:
    """Inverse of :func:`ilv_tf32_pack_weights`: each conv's
    ``repack_ilv`` weight (3 C_in, 3 C_out) as hi + lo."""
    inverse = torch.argsort(_swizzle128(3 * GROWTH))
    halves, o = [], 0
    for nk in _ILV_TF32_SLOT_KST:
        n = nk * 2 * 3 * GROWTH * _ILV_TF32_KC
        t = packed[o:o + n].view(nk, 2, -1)[..., inverse]
        t = (t[:, 0] + t[:, 1]).view(nk, 3 * GROWTH, _ILV_TF32_KC)
        halves.append(t.transpose(1, 2).reshape(-1, 3 * GROWTH))
        o += n
    return _ilv_conv5(halves)


def rdb_ilv_runs_reference(x: torch.Tensor, kernels, biases,
                           scale_ratio: float = 0.2):
    """The plain version of the interleaved bf16 forward's data flow
    (``csrc/rdb_ilv.cu``, ``ilv_sm90``), in ``x.dtype``: the buffer starts
    as NaN, the prep writes x's chunks (zeros past each image's top and
    bottom); then per conv and run (:func:`ilv_runs`) one product of the
    run's 128 prefix rows (zeros past the buffer's ends) with the
    ``repack_ilv`` weight, the taps reduced with the column masks (m mod
    W), the bias, LeakyReLU and one rounding, and the stores of
    :func:`ilv_stores` (with the prep's zeros) into the new chunk; conv 5
    stores x + scale * out.  Returns the block output and the (B, H, W,
    576) buffer: an element no store reached stays NaN."""
    _check(x, kernels, biases)
    dt, acc = x.dtype, _acc_dtype(x.dtype)
    b, h, w, _ = x.shape
    m = b * h * w
    xf = x.reshape(m, CHANNELS)
    buf = x.new_full((m, 3 * FEAT), float("nan"))
    pix = torch.arange(m)
    row = pix // w % h
    first, last = row == 0, row == h - 1
    for j in range(CHANNELS // GROWTH):
        xs = xf[:, j * GROWTH:(j + 1) * GROWTH]
        buf[:, ilv_columns(j, 1)] = xs
        buf[:, ilv_columns(j, 0)] = torch.where(
            first[:, None], 0, xs[(pix - w).clamp(min=0)])
        buf[:, ilv_columns(j, 2)] = torch.where(
            last[:, None], 0, xs[(pix + w).clamp(max=m - 1)])
    stores = ilv_stores(b, h, w)
    m0 = torch.tensor([r[0] for r in ilv_runs(b, h, w)])
    rows = m0[:, None] - 1 + torch.arange(_ILV_RUN)
    inside = ((rows >= 0) & (rows < m))[..., None]
    outs = rows[:, 1:-1]
    keep = outs < m
    col = outs % w
    out = torch.empty_like(xf)
    for i, (cin, cout) in enumerate(zip(CIN, COUT)):
        wi = repack_ilv(pack_kernel(kernels[i].to(dt)), cin).to(acc)
        a = torch.where(inside, buf[rows.clamp(0, m - 1), :3 * cin], 0)
        y = a.to(acc) @ wi
        v = y[:, 1:-1, cout:2 * cout]
        v = torch.where((col > 0)[..., None], y[:, :-2, :cout] + v, v)
        v = torch.where((col < w - 1)[..., None], v + y[:, 2:, 2 * cout:], v)
        v = v + biases[i].to(acc)
        if i == 4:
            res = xf[outs.clamp(max=m - 1)].to(acc)
            out[outs[keep]] = (v * scale_ratio + res)[keep].to(dt)
            break
        val = x.new_empty((m, cout))
        val[outs[keep]] = F.leaky_relu(v, 0.2).to(dt)[keep]
        chunk = cin // GROWTH
        for part, name in enumerate(("up", "mid", "dn")):
            dest, src = stores[name]
            buf[dest, ilv_columns(chunk, part)] = torch.where(
                (src < 0)[:, None], 0, val[src.clamp(min=0)])
    return out.reshape(b, h, w, CHANNELS), buf.reshape(b, h, w, 3 * FEAT)


def rdb_ilv_3xtf32_reference(x: torch.Tensor, kernels, biases,
                             scale_ratio: float = 0.2, *, terms=None):
    """The interleaved f32 forward kernels' arithmetic in plain PyTorch
    (3xTF32, ``csrc/rdb_ilv_tf32_sm90.cuh``): the (B, H, W, 576) buffer of
    ``rdb_ilv_reference`` in f32; per conv, per 32-channel chunk of its
    prefix (the kernel's chain: 96 columns, the chunk's up, mid and dn),
    the products of the TF32 parts (``ops/tf32.py`` ``tf32_split``) of
    the prefix (A, split in registers) and of the ``repack_ilv`` weight
    (B, the prep's planes) that ``terms`` names (``TF32_TERMS``, the
    default: hi.lo, lo.hi, hi.hi; fewer terms: a wrong kernel), summed in
    f32; the chains added into f32 sums in order, as the kernel adds them
    (its tensor-core chain summed in f32 here); the taps
    reduced with the column masks, the bias, LeakyReLU into the next
    chunk (nothing rounded) or x + scale * conv5.  Returns the block
    output and the buffer."""
    from torchsr_tpu_torch.ops.tf32 import TF32_TERMS, tf32_parts

    _check(x, kernels, biases)
    terms = TF32_TERMS if terms is None else terms
    xf = x.float()
    b, h, w, _ = x.shape
    buf = xf.new_zeros((b, h, w, 3 * FEAT))
    _ilv_grow(buf, xf, 0)
    for i, (cin, cout) in enumerate(zip(CIN, COUT)):
        a = tf32_parts(buf[..., :3 * cin])
        k = tf32_parts(repack_ilv(pack_kernel(kernels[i].float()), cin))
        y = 0
        for c in range(0, 3 * cin, _ILV_TF32_CHAIN):
            cols = slice(c, c + _ILV_TF32_CHAIN)
            y = y + sum(a[p][..., cols] @ k[q][cols] for p, q in terms)
        acc = _reduce_taps(y, cout) + biases[i].float()
        if i < 4:
            _ilv_grow(buf, F.leaky_relu(acc, 0.2), cin // GROWTH)
    return (acc * scale_ratio + xf).contiguous(), buf


def rdb_fwd_ilv_cuda(
    x: torch.Tensor, kernels, biases, *, scale_ratio: float = 0.2
) -> tuple[torch.Tensor, torch.Tensor]:
    """The interleaved forward on a CUDA ``x`` (``csrc/rdb_ilv.cu``).
    Returns the block output and the (B, H, W, 576) buffer the launches
    filled (chunk j's [up | mid | dn] in columns ``ilv_columns``), so that
    each launch can be held against its own convolution.  The kernels go
    to the kernel as they are (f32, or in bf16 also bf16; any strides): a
    prep launch and five convs.  bf16 has the data flow of
    :func:`rdb_ilv_runs_reference`; f32 the same runs and stores with
    each product taken as three TF32 ones (:func:`rdb_ilv_3xtf32_reference`
    is that arithmetic), whatever ``torch.backends``' TF32 switches say."""
    global RDB_FWD_ILV_LAUNCHES, RDB_FWD_ILV_F32_LAUNCHES
    kernels, biases = tuple(kernels), tuple(biases)
    _check(x, kernels, biases)
    _cuda_operands(x, (*kernels, *biases), "rdb_fwd_ilv_cuda")
    b, h, w, _ = x.shape
    if b * h * w >= 2**31 - _ILV_RUN:
        raise ValueError(
            f"the interleaved RDB forward takes fewer than 2**31 pixels a "
            f"call, got {b * h * w}")
    x = x.contiguous()
    buf = torch.empty((b, h, w, 3 * FEAT), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _fwd_launch("rdb_ilv", x, kernels, biases, scale_ratio, buf, out)
    if x.dtype == torch.float32:
        RDB_FWD_ILV_F32_LAUNCHES += 5
    else:
        RDB_FWD_ILV_LAUNCHES += 5
    return out, buf
