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
(one direct-conv kernel launched five times, filling the feature buffer)
and, in the backward, ``csrc/rdb_bwd.cu`` (the five convs reversed from
the buffer; design and bound in the headers).  A CPU tensor runs the
plain versions, ``rdb_reference`` and ``rdb_bwd_reference``, through the
same Function.  There is no fallback: on CUDA the kernel runs or the
call raises.

Precision (the TPU kernels' contract): products take working-dtype
operands (bf16 under AMP, else f32) and accumulate in f32; biases, dW,
db and the dense-gradient accumulator stay f32; dx is stored in the
working dtype.  The weight gradients reach the f32 parameters in f32,
never rounded through bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHANNELS = 64
GROWTH = 32
CIN = (64, 96, 128, 160, 192)
COUT = (32, 32, 32, 32, 64)
FEAT = CIN[-1]

# Kernel launches by the forward on CUDA: five per block.  A run reads
# it to show that its path went through the kernel.
RDB_FWD_LAUNCHES = 0
# Block backwards run by the backward kernels on CUDA: one per block
# (each one 20 launches of csrc/rdb_bwd.cu: prep, wgrad, reduce and
# dgrad for each of the five convs).
RDB_BWD_LAUNCHES = 0

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Z = 65535  # CUDA's limit on gridDim.z, which carries the batch
# The backward's dgrad launches carry batch x (C_in / 32) CTAs in z
_MAX_BWD_BATCH = _MAX_GRID_Z // (FEAT // 32)
# Pixels summed into one block partial of db by the prep launches
_PREP_PIXELS = 1024
# CTAs of a wgrad launch, each writing an f32 partial of dW over its
# share of the 8 x 32-pixel tiles: two per SM of the H100's 132, and
# few partials for the reduce launch to sum
_WGRAD_CTAS = 264


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


class _FusedRDB(torch.autograd.Function):
    """The block with its feature buffer as the saved residual; kernels
    on CUDA, plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, scale_ratio, *params):
        kernels, biases = params[:5], params[5:]
        if x.device.type == "cuda":
            out, feat = rdb_fwd_cuda(x, kernels, biases,
                                     scale_ratio=scale_ratio)
        else:
            out, feat = _rdb_plain(x, kernels, biases, scale_ratio)
        ctx.scale_ratio = scale_ratio
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(feat, *kernels)
        return out

    @staticmethod
    def backward(ctx, g):
        feat, *kernels = ctx.saved_tensors
        if feat.device.type == "cuda":
            dx, dws, dbs, _ = rdb_bwd_cuda(g, feat, kernels,
                                           scale_ratio=ctx.scale_ratio)
        else:
            dx, dws, dbs = rdb_bwd_reference(g.to(feat.dtype), feat,
                                             kernels, ctx.scale_ratio)
        dws = [dw.to(k.dtype) for dw, k in zip(dws, kernels)]
        return (dx, None, *dws, *dbs)


def fused_rdb(
    x: torch.Tensor, kernels, biases, *, scale_ratio: float = 0.2
) -> torch.Tensor:
    """Residual dense block ``x + scale_ratio * conv5(dense(x))``.

    ``x``: (B, H, W, 64) NHWC, f32 or bf16.  ``kernels``: five HWIO
    (3, 3, C_in, C_out) kernels; ``biases``: five (C_out,) vectors.  On
    CUDA the kernels are used in ``x.dtype`` and the biases in f32.
    Differentiable in x, the kernels and the biases."""
    kernels, biases = tuple(kernels), tuple(biases)
    _check(x, kernels, biases)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"fused_rdb runs on CUDA (kernel) or CPU (plain version), "
            f"not on {x.device}"
        )
    return _FusedRDB.apply(x, float(scale_ratio), *kernels, *biases)


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
    block output and the (B, H, W, 192) feature buffer the five launches
    filled (x, then the four grown 32-channel slices), so that each
    launch can be held against its own convolution, and the backward
    can start from it."""
    global RDB_FWD_LAUNCHES
    from torchsr_tpu_torch.ops._build import load_library

    kernels, biases = tuple(kernels), tuple(biases)
    _check(x, kernels, biases)
    _cuda_operands(x, (*kernels, *biases), "rdb_fwd_cuda")
    if x.shape[0] > _MAX_GRID_Z:
        raise ValueError(
            f"fused_rdb takes at most {_MAX_GRID_Z} images per call, "
            f"got {x.shape[0]}"
        )
    x = x.contiguous()
    kernels = [_aligned(k, x.dtype) for k in kernels]
    biases = [b.to(torch.float32).contiguous() for b in biases]
    b, h, w, _ = x.shape
    feat = torch.empty((b, h, w, FEAT), dtype=x.dtype, device=x.device)
    feat[..., :CHANNELS].copy_(x)
    out = torch.empty_like(x)

    lib = load_library("rdb_fwd")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    is_bf16 = int(x.dtype == torch.bfloat16)
    for i in range(5):
        dst = out if i == 4 else feat
        err = lib.rdb_conv3x3_launch(
            i, is_bf16, feat.data_ptr(), kernels[i].data_ptr(),
            biases[i].data_ptr(), dst.data_ptr(), b, h, w,
            float(scale_ratio), x.device.index, stream,
        )
        _raise_on(err, lib.rdb_error_string, f"rdb_fwd conv {i + 1}")
        RDB_FWD_LAUNCHES += 1
    return out, feat


def flipped_kernel(k: torch.Tensor) -> torch.Tensor:
    """The kernel of the transposed conv (dgrad) as a direct conv: HWIO
    (3, 3, C_in, C_out) -> taps flipped, channels swapped (3, 3, C_out,
    C_in)."""
    return k.flip(0, 1).transpose(2, 3)


def rdb_bwd_cuda(
    g: torch.Tensor, feat: torch.Tensor, kernels, *,
    scale_ratio: float = 0.2,
):
    """The kernel path of the backward on CUDA.  ``g``: the (B, H, W,
    64) output cotangent; ``feat``: the forward's (B, H, W, 192) feature
    buffer in the working dtype; ``kernels``: the five HWIO kernels.

    Returns ``(dx, dws, dbs, dfeat)``: dx (B, H, W, 64) in ``feat.dtype``,
    five f32 HWIO dW, five f32 db, and the f32 (B, H, W, 192) dense
    gradient the launches accumulated (dx - g is its first 64 channels),
    so that each stage can be held against its own plain computation."""
    global RDB_BWD_LAUNCHES
    from torchsr_tpu_torch.ops._build import load_library

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
    b, h, w, _ = feat.shape
    if b > _MAX_BWD_BATCH:
        raise ValueError(
            f"the RDB backward takes at most {_MAX_BWD_BATCH} images per "
            f"call, got {b}"
        )
    dt = feat.dtype
    feat = feat.contiguous()
    g = _aligned(g, dt)
    wts = [_aligned(flipped_kernel(k), dt) for k in kernels]
    m = b * h * w
    n_tiles = b * -(-h // 8) * -(-w // 32)
    nblocks = -(-m // _PREP_PIXELS)
    dev = feat.device
    dfeat = torch.empty((b, h, w, FEAT), dtype=torch.float32, device=dev)
    dx = torch.empty((b, h, w, CHANNELS), dtype=dt, device=dev)
    dy = torch.empty((m, CHANNELS), dtype=dt, device=dev)
    db_part = torch.empty((nblocks, CHANNELS), dtype=torch.float32,
                          device=dev)
    groups = [min(n_tiles, max(1, _WGRAD_CTAS // (cin // 32)))
              for cin in CIN]
    dw_part = torch.empty(
        max(gr * 9 * ci * co for gr, ci, co in zip(groups, CIN, COUT)),
        dtype=torch.float32, device=dev)
    dws = [torch.empty((3, 3, ci, co), dtype=torch.float32, device=dev)
           for ci, co in zip(CIN, COUT)]
    dbs = [torch.empty((co,), dtype=torch.float32, device=dev)
           for co in COUT]

    lib = load_library("rdb_bwd")
    errstr = lib.rdb_bwd_error_string
    stream = torch.cuda.current_stream(dev).cuda_stream
    is_bf16 = int(dt == torch.bfloat16)
    idx = dev.index
    for i in reversed(range(5)):
        src = g if i == 4 else dfeat
        _raise_on(lib.rdb_bwd_prep_launch(
            i, is_bf16, src.data_ptr(), feat.data_ptr(), dy.data_ptr(),
            db_part.data_ptr(), m, nblocks, float(scale_ratio), idx,
            stream), errstr, f"rdb_bwd prep {i + 1}")
        _raise_on(lib.rdb_bwd_wgrad_launch(
            i, is_bf16, feat.data_ptr(), dy.data_ptr(), dw_part.data_ptr(),
            b, h, w, groups[i], idx, stream), errstr, f"rdb_bwd wgrad {i + 1}")
        _raise_on(lib.rdb_bwd_reduce_launch(
            dw_part.data_ptr(), groups[i], dws[i].numel(),
            db_part.data_ptr(), nblocks, COUT[i], dws[i].data_ptr(),
            dbs[i].data_ptr(), idx, stream), errstr, f"rdb_bwd reduce {i + 1}")
        _raise_on(lib.rdb_bwd_dgrad_launch(
            i, is_bf16, dy.data_ptr(), wts[i].data_ptr(), dfeat.data_ptr(),
            g.data_ptr(), dx.data_ptr(), b, h, w, idx, stream),
            errstr, f"rdb_bwd dgrad {i + 1}")
    RDB_BWD_LAUNCHES += 1
    return dx, tuple(dws), tuple(dbs), dfeat
