"""3x3 64 -> 64 convolution: CUDA kernels for forward and backward, and
their plain versions.

``pair_conv`` is the PyTorch counterpart of the JAX package's
``torchsr_tpu/ops/pallas/pair_conv.py`` ``pair_conv`` (its TPU kernels
``_fwd_kernel``, pair_conv.py:134, and ``_bwd_kernel``, :148), with the
same layouts and the same shape gate: NHWC x (B, H, W, 64) in f32 or
bf16, an HWIO kernel (3, 3, 64, 64) and an optional (64,) f32 bias; a
3x3 stride-1 SAME convolution with symmetric zero padding.  Both
packages take the same raw arrays (no pair packing crosses the
boundary), so the tests hand the same seeded numpy ``x``, kernel and
bias to both and no converter is needed.

Precision (the JAX package's ``_primal`` :300 and ``_pair_conv_bwd``
:323): the kernel is cast to x's dtype, products accumulate in f32 with
the bias added in f32 in the accumulator, and the sum is rounded once to
x's dtype.  Backward: g is cast to x's dtype first; dx is the same conv
of g with the flipped, transposed kernel (no bias), in x's dtype; dW
sums x's windows times g over every pixel in f32 and is returned in the
kernel's dtype; db sums the rounded g in f32.

The TPU kernels pack two pixels per 128-lane row to fill the MXU; the
Hopper kernels (``csrc/pair_conv.cu``, design and bound in its header)
compute the plain conv: in bf16 on ``wgmma`` over a persistent grid that
walks runs of up to 128 output pixels, ``conv_runs`` and
``conv_schedule`` below mirroring their schedule.  The kernels read the
caller's kernel (f32 or x's dtype) and round and flip it themselves, so
no weight copy is made on the host.  A CUDA tensor runs them through ``_PairConv``;
a CPU tensor runs the plain versions, ``pair_conv_reference`` and
``pair_conv_bwd_reference``, through the same Function.  There is no
fallback: on CUDA the kernel runs or the call raises.  The JAX
function's ``mesh`` argument (shard_map over a device mesh) is not
ported: multi-device runs are ROADMAP A12.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from torchsr_tpu_torch.ops.rdb import _aligned, _cuda_operands, _raise_on

C = 64  # the only channel count the gate admits
# The JAX package's per-image cap (pair_conv.py:58): H * W / 2 pair rows
_MAX_IMAGE_PAIR_ROWS = 16384
# Forward calls (one conv launch each) and backward calls (a dgrad, a
# wgrad and a reduce launch each) on CUDA.  A run reads them to show
# that its path went through the kernels.
PAIR_FWD_LAUNCHES = 0
PAIR_BWD_LAUNCHES = 0
# The bf16 kernels' schedule (csrc/pair_conv.cu): runs of up to _RUN
# output pixels of one image, across row ends where W <= _NARROW_W, else
# inside one row; min(runs, _CTAS) persistent CTAs, one per SM of the
# H100 (a CTA's stages take most of an SM's shared memory), CTA c
# walking runs c, c + grid, ...  A stage holds _HALO_MAX halo pixels.
_RUN = 128
_NARROW_W = 64
_CTAS = 132
_HALO_MAX = 392
# The f32 wgrad: CTAs per 32-channel chunk, each summing the 8 x 32
# pixel tiles k, k + groups, ... into an f32 partial of dW
_F32_WGRAD_GROUPS = 132
_F32_WGRAD_TILE = (8, 32)


def pair_conv_supported(shape, kernel_shape=(3, 3, C, C)) -> bool:
    """The JAX package's shape gate (pair_conv.py:341): a 3x3 64 -> 64
    kernel, 64 channels, an even width and at most 16384 pixel pairs per
    image.  The Hopper kernels need neither of the last two; the port
    admits what the JAX package admits."""
    if tuple(kernel_shape) != (3, 3, C, C):
        return False
    b, h, w, c = shape
    return c == C and w % 2 == 0 and h * (w // 2) <= _MAX_IMAGE_PAIR_ROWS


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _oihw(k: torch.Tensor) -> torch.Tensor:
    return k.permute(3, 2, 0, 1)


def pair_conv_reference(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """The kernels' forward arithmetic in plain PyTorch: an f32 conv of
    x and the kernel rounded to x's dtype, plus the f32 bias, rounded
    once to x's dtype."""
    y = F.conv2d(_nchw(x.float()), _oihw(kernel.to(x.dtype).float()),
                 bias.float(), padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def pair_conv_bwd_reference(x: torch.Tensor, kernel: torch.Tensor,
                            g: torch.Tensor):
    """The kernels' backward arithmetic in plain PyTorch: ``(dx, dW,
    db)``, dx in x's dtype, dW and db in f32, from g rounded to x's
    dtype (the JAX package's ``_pair_conv_bwd``)."""
    g = g.to(x.dtype).float()
    k = kernel.to(x.dtype).float()
    dx = torch.nn.grad.conv2d_input(_nchw(x).shape, _oihw(k), _nchw(g),
                                    padding=1)
    dw = torch.nn.grad.conv2d_weight(_nchw(x.float()), _oihw(k).shape,
                                     _nchw(g), padding=1)
    return (dx.permute(0, 2, 3, 1).to(x.dtype), dw.permute(2, 3, 1, 0),
            g.sum(dim=(0, 1, 2)))


def conv_reference(x: torch.Tensor, kernel: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """The JAX package's ``conv_reference`` (pair_conv.py:403): the conv
    in x's dtype, then the bias rounded to it (the bench tool's
    baseline; in bf16 it differs from the kernels by that rounding)."""
    y = F.conv2d(_nchw(x), _oihw(kernel.to(x.dtype)), padding=1)
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias.to(y.dtype)


class _PairConv(torch.autograd.Function):
    """The conv with x and the kernel as the saved residuals; kernels on
    CUDA, plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        cuda = x.device.type == "cuda"
        y = (pair_conv_fwd_cuda if cuda else pair_conv_reference)(
            x, kernel, bias)
        ctx.save_for_backward(x, kernel)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        bwd = (pair_conv_bwd_cuda if x.device.type == "cuda"
               else pair_conv_bwd_reference)
        dx, dw, db = bwd(x, kernel, g)
        return dx, dw.to(kernel.dtype), db.to(ctx.bias_dtype)


def pair_conv(x: torch.Tensor, kernel: torch.Tensor,
              bias: torch.Tensor | None = None, *,
              devices: list | None = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv, 64 -> 64 channels, NHWC, differentiable in
    x, the kernel and the bias.  Refuses, with the JAX package's
    message, any shape ``pair_conv_supported`` does not admit.

    ``devices`` (the JAX package's ``mesh`` / ``batch_axis``): with more
    than one device and a batch they divide, the batch is split into
    equal parts, part i runs on ``devices[i]`` (operands copied there)
    and the outputs are concatenated on x's device; the copies are
    differentiable, so the kernel's and bias's gradients sum the
    parts'."""
    if devices is not None and len(devices) > 1 \
            and x.shape[0] % len(devices) == 0:
        home = x.device
        parts = [pair_conv(xp.to(d), kernel.to(d),
                           None if bias is None else bias.to(d))
                 for xp, d in zip(x.chunk(len(devices)), devices)]
        return torch.cat([p.to(home) for p in parts])
    if not pair_conv_supported(x.shape, kernel.shape):
        raise ValueError(
            f"pair_conv: unsupported shapes x={tuple(x.shape)} "
            f"kernel={tuple(kernel.shape)}"
        )
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"pair_conv runs on CUDA (kernel) or CPU (plain version), not "
            f"on {x.device}")
    if bias is None:
        bias = torch.zeros((C,), dtype=torch.float32, device=x.device)
    return _PairConv.apply(x, kernel, bias)


def _check_cuda(x: torch.Tensor, kernel: torch.Tensor, what: str) -> None:
    if x.dim() != 4 or x.shape[-1] != C or kernel.shape != (3, 3, C, C):
        raise ValueError(
            f"{what} takes x (B, H, W, {C}) and a (3, 3, {C}, {C}) kernel, "
            f"got {tuple(x.shape)} and {tuple(kernel.shape)}")


def conv_runs(b: int, h: int, w: int) -> list:
    """The bf16 kernels' tiles, image by image: ``(image, p0, n)``, the
    output pixels p0 .. p0 + n - 1 of the image flattened as y * w + x."""
    if w <= _NARROW_W:
        per = [(p0, min(_RUN, h * w - p0)) for p0 in range(0, h * w, _RUN)]
    else:
        per = [(y * w + x0, min(_RUN, w - x0)) for y in range(h)
               for x0 in range(0, w, _RUN)]
    return [(i, p0, n) for i in range(b) for p0, n in per]


def conv_ctas(b: int, h: int, w: int) -> int:
    """The bf16 kernels' persistent grid: min(runs, _CTAS), counted as
    the kernels count the runs."""
    per = -(-h * w // _RUN) if w <= _NARROW_W else h * -(-w // _RUN)
    return min(b * per, _CTAS)


def conv_schedule(b: int, h: int, w: int) -> list:
    """The runs (indices into ``conv_runs``) each persistent CTA of the
    bf16 conv and wgrad walks, in order; the wgrad's CTA c writes dW's
    partial c."""
    runs, ctas = len(conv_runs(b, h, w)), conv_ctas(b, h, w)
    return [list(range(c, runs, ctas)) for c in range(ctas)]


def wgrad_groups(b: int, h: int, w: int, dtype=torch.bfloat16) -> int:
    """The wgrad's f32 partials of dW for a (b, h, w) batch: one per
    persistent CTA in bf16, one per group of 8 x 32 tiles in f32."""
    if dtype == torch.bfloat16:
        return conv_ctas(b, h, w)
    th, tw = _F32_WGRAD_TILE
    return max(1, min(_F32_WGRAD_GROUPS, b * -(-h // th) * -(-w // tw)))


def wgrad_partition(b: int, h: int, w: int, dtype) -> torch.Tensor:
    """The partial of dW each pixel's products go to: (b, h, w) int64."""
    if dtype == torch.bfloat16:
        part = torch.empty((b, h * w), dtype=torch.int64)
        runs = conv_runs(b, h, w)
        for cta, walk in enumerate(conv_schedule(b, h, w)):
            for t in walk:
                img, p0, n = runs[t]
                part[img, p0:p0 + n] = cta
        return part.view(b, h, w)
    th, tw = _F32_WGRAD_TILE
    nh, nw = -(-h // th), -(-w // tw)
    tile = (torch.arange(b).view(b, 1, 1) * nh * nw
            + (torch.arange(h) // th).view(1, h, 1) * nw
            + (torch.arange(w) // tw).view(1, 1, w))
    return tile % wgrad_groups(b, h, w, dtype)


def _kernel_operand(kernel: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The kernel as the CUDA kernels read it: f32 or x's dtype, as the
    caller passed it (copied only to make it so, contiguous or 16-byte
    aligned)."""
    kdt = kernel.dtype if kernel.dtype in (torch.float32, dt) else dt
    return _aligned(kernel, kdt)


def pair_conv_fwd_cuda(x: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """The forward kernel on a CUDA ``x``: one launch."""
    global PAIR_FWD_LAUNCHES
    from torchsr_tpu_torch.ops._build import load_library

    _check_cuda(x, kernel, "pair_conv_fwd_cuda")
    _cuda_operands(x, (kernel, bias), "pair_conv_fwd_cuda")
    dt = x.dtype
    x = _aligned(x, dt)
    kernel = _kernel_operand(kernel, dt)
    bias = bias.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    b, h, w, _ = x.shape
    lib = load_library("pair_conv")
    err = lib.pair_conv_launch(
        int(dt == torch.bfloat16), int(kernel.dtype == torch.float32), 0,
        x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), y.data_ptr(), b,
        h, w, conv_ctas(b, h, w), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(err, lib.pair_conv_error_string, "pair_conv forward")
    PAIR_FWD_LAUNCHES += 1
    return y


def pair_conv_bwd_cuda(x: torch.Tensor, kernel: torch.Tensor,
                       g: torch.Tensor):
    """The backward kernels on CUDA: the dgrad (the forward kernel on g,
    reading the kernel flipped and transposed), the wgrad's f32 partials
    of dW and db, and their fixed-order reduce: three launches.  Returns
    ``(dx, dW, db)``: dx in x's dtype, dW (3, 3, 64, 64) and db (64,) in
    f32."""
    global PAIR_BWD_LAUNCHES
    from torchsr_tpu_torch.ops._build import load_library

    _check_cuda(x, kernel, "pair_conv_bwd_cuda")
    if g.shape != x.shape:
        raise ValueError(
            f"g must have x's shape {tuple(x.shape)}, got {tuple(g.shape)}")
    _cuda_operands(x, (kernel, g), "pair_conv_bwd_cuda")
    dt, dev = x.dtype, x.device
    x = _aligned(x, dt)
    g = _aligned(g, dt)
    kernel = _kernel_operand(kernel, dt)
    b, h, w, _ = x.shape
    groups = wgrad_groups(b, h, w, dt)
    dx = torch.empty_like(x)
    dw_part = torch.empty((groups, 3, 3, C, C), dtype=torch.float32,
                          device=dev)
    db_part = torch.empty((groups, C), dtype=torch.float32, device=dev)
    dw = torch.empty((3, 3, C, C), dtype=torch.float32, device=dev)
    db = torch.empty((C,), dtype=torch.float32, device=dev)
    lib = load_library("pair_conv")
    stream = torch.cuda.current_stream(dev).cuda_stream
    is_bf16 = int(dt == torch.bfloat16)
    errstr = lib.pair_conv_error_string
    _raise_on(lib.pair_conv_launch(
        is_bf16, int(kernel.dtype == torch.float32), 1, g.data_ptr(),
        kernel.data_ptr(), None, dx.data_ptr(), b, h, w,
        conv_ctas(b, h, w), dev.index, stream), errstr, "pair_conv dgrad")
    _raise_on(lib.pair_conv_wgrad_launch(
        is_bf16, x.data_ptr(), g.data_ptr(), dw_part.data_ptr(),
        db_part.data_ptr(), b, h, w, groups, dev.index, stream), errstr,
        "pair_conv wgrad")
    _raise_on(lib.pair_conv_reduce_launch(
        dw_part.data_ptr(), groups, dw.numel(), db_part.data_ptr(), groups,
        C, dw.data_ptr(), db.data_ptr(), dev.index, stream), errstr,
        "pair_conv reduce")
    PAIR_BWD_LAUNCHES += 1
    return dx, dw, db
