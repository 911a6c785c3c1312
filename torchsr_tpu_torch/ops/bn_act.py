"""BatchNorm with its epilogue (PReLU, or a skip add) on NHWC tensors: a
CUDA kernel pair each way, and its plain version.

``bn_act(x, bn, prelu=..., residual=...)`` is what the SRGAN generator's
residual blocks and long skip compute: ``bn`` (a ``models.layers.
BatchNorm``) on the conv output ``x``, then ``prelu`` or ``+ residual``
(or neither).  The plain version, ``bn_act_reference``, is that
composition as the generator ran it before: ``BatchNorm.forward`` (the
activation cast to f32, ``nn.BatchNorm2d`` on an NCHW view, the result
cast back), then ``PReLU.forward`` or the add, each rounding to x's dtype
where the composition rounds.  The wrapper takes it for CPU tensors; with
``bn.sync_group`` set in training (statistics over every rank, an
all-reduce between the passes); and inside ``ops.rdb.plain_forward``
(what a portable, pure-aten export traces).  For CUDA tensors otherwise
it launches the kernels (``csrc/bn_act.cu``) through ``_BNAct`` or
raises: there is no fallback.

The kernels replace no TPU kernel: the JAX package leaves BatchNorm to
XLA.  They were added because the composition made, for each of the
SRGAN generator's 33 BatchNorms a step, an f32 copy of the bf16
activation, cuDNN's NCHW kernels with layout transposes around them, a
cast back and the epilogue's own passes, forward and backward.  Their
bound is bytes: at the SRGAN pretrain's (128, 24, 24, 64) bf16 one
activation is 9.44 MB, 2.82 us at 3.35 TB/s, so a forward (x in, out
out) is 5.6 us (8.5 with the skip) and a backward (x and dy in, dx out)
8.5 us.  Each direction is two launches over the same rows: a reduction
into one partial per CTA, then a pass that merges the partials and
writes the elementwise result, re-reading its rows from the L2 the first
pass filled (design in ``csrc/bn_act.cu``).  The arithmetic is the
composition's at its precision: statistics and sums in f32, the output
rounded to x's dtype before the PReLU or the add as the composition
rounds it, the slope's gradient rounded as autograd rounds it.  The
forward saves x, the mean and invstd; the backward recomputes xhat, the
BatchNorm output and the PReLU mask from them.  The sums are taken in
another order than cuDNN's, so the results differ from the plain
version's by f32 rounding (and, after a rounding to bf16, by a bf16 tie
rounded the other way).

Accepted: x in bf16 or f32, NHWC, C a multiple of 8 and at most 256;
``bn``'s parameters and statistics in f32, running statistics tracked, a
momentum; where the kernels run, x and the residual contiguous.  Anything
else raises.
"""

from __future__ import annotations

import torch

from torchsr_tpu_torch.ops import rdb as rdb_ops
from torchsr_tpu_torch.ops.rdb import _raise_on

# Forward calls (two launches in training, one in eval) and backward
# calls (two launches) on CUDA, bf16 and f32 apart.  train/graphs.py adds
# a captured step's share of each once per replay.
BN_ACT_FWD_LAUNCHES = 0
BN_ACT_BWD_LAUNCHES = 0
BN_ACT_FWD_F32_LAUNCHES = 0
BN_ACT_BWD_F32_LAUNCHES = 0
LAUNCH_COUNTERS = ("BN_ACT_FWD_LAUNCHES", "BN_ACT_BWD_LAUNCHES",
                   "BN_ACT_FWD_F32_LAUNCHES", "BN_ACT_BWD_F32_LAUNCHES")

MAX_C = 256
# The kernels' grid (csrc/bn_act.cu): CTAs of _THREADS threads, C / 8 a
# row, at most _CTAS of them (one an SM of the H100), each owning a run of
# consecutive rows.
_THREADS = 512
_CTAS = 132
_EPI_NONE, _EPI_PRELU, _EPI_ADD = 0, 1, 2


def bn_act_reference(x: torch.Tensor, bn, *, prelu=None,
                     residual: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: ``bn(x)``, then ``prelu`` or ``+ residual``."""
    z = bn(x)
    if prelu is not None:
        return prelu(z)
    if residual is not None:
        return z + residual
    return z


def bn_act_grid(rows: int, c: int) -> tuple[int, int]:
    """The kernels' grid for ``rows`` rows of ``c`` channels: ``(ctas,
    rows per CTA)``; CTA b owns rows b * rpb .. (b + 1) * rpb - 1."""
    lanes = _THREADS // (c // 8)
    ctas = max(1, min(_CTAS, -(-rows // lanes)))
    rpb = -(-rows // ctas)
    return -(-rows // rpb), rpb


def _check(x: torch.Tensor, bn, prelu, residual, kernels: bool) -> None:
    """Raise on what the kernels do not take; the layout and the
    alignment only where they run (``kernels``): the plain version takes
    any strides and offsets."""
    if prelu is not None and residual is not None:
        raise ValueError("bn_act takes a PReLU or a residual, not both")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"bn_act takes bfloat16 or float32, not {x.dtype}")
    if x.dim() != 4 or (kernels and not x.is_contiguous()):
        raise ValueError(
            f"bn_act takes a contiguous NHWC tensor, got shape "
            f"{tuple(x.shape)} strides {x.stride()}")
    c = x.shape[-1]
    if c % 8 or not 8 <= c <= MAX_C or c != bn.num_features:
        raise ValueError(
            f"bn_act takes C a multiple of 8, at most {MAX_C}, equal to the "
            f"BatchNorm's {bn.num_features}; got C = {c}")
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device
            or (kernels and not residual.is_contiguous())):
        raise ValueError(
            f"bn_act's residual must be a contiguous {x.dtype} tensor of "
            f"x's shape {tuple(x.shape)} on {x.device}")
    if kernels and any(t is not None and t.data_ptr() % 16
                       for t in (x, residual)):
        raise ValueError(
            "bn_act takes x and the residual at 16-byte aligned addresses "
            "(the kernels read them in 16-byte vectors)")
    if prelu is not None and prelu.weight.numel() != 1:
        raise ValueError("bn_act's PReLU has one shared slope")
    if bn.running_mean is None or bn.momentum is None or not bn.affine:
        raise ValueError("bn_act takes an affine BatchNorm that tracks its "
                         "running statistics with a momentum")


def bn_act(x: torch.Tensor, bn, *, prelu=None,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """``bn`` on NHWC ``x`` and its epilogue: ``prelu(bn(x))``, ``bn(x) +
    residual`` or ``bn(x)``, differentiable in x, the BatchNorm's
    parameters, the slope and the residual; in training mode it updates
    ``bn``'s running statistics and ``num_batches_tracked``."""
    plain = (x.device.type == "cpu" or rdb_ops._PLAIN.get()
             or (bn.training and bn.sync_group is not None))
    _check(x, bn, prelu, residual, kernels=not plain)
    if plain:
        return bn_act_reference(x, bn, prelu=prelu, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(
            f"bn_act runs on CUDA (kernels) or the CPU (plain version), not "
            f"on {x.device}")
    epi = (_EPI_PRELU if prelu is not None
           else _EPI_ADD if residual is not None else _EPI_NONE)
    return _BNAct.apply(x, bn.weight, bn.bias,
                        None if prelu is None else prelu.weight, residual,
                        bn, epi)


class _BNAct(torch.autograd.Function):
    """The kernels, with x, the BatchNorm's parameters, the slope and the
    forward's mean and invstd saved."""

    @staticmethod
    def forward(ctx, x, weight, bias, slope, residual, bn, epi):
        y, stats = bn_act_fwd_cuda(x, bn, slope=slope, residual=residual,
                                   epi=epi)
        ctx.save_for_backward(x, weight, bias, slope, stats)
        ctx.epi, ctx.train = epi, bn.training
        ctx.has_residual = residual is not None
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, bias, slope, stats = ctx.saved_tensors
        dx, dw, db, ds = bn_act_bwd_cuda(
            x, g.contiguous(), weight, bias, stats, slope=slope,
            epi=ctx.epi, train=ctx.train)
        return dx, dw, db, ds, g if ctx.has_residual else None, None, None


def _cuda_tensors(x: torch.Tensor, tensors, what: str,
                  residual=None) -> None:
    """Raise unless ``tensors`` share x's device and take x's dtype, f32
    or int64, and x and the residual (read in 16-byte vectors) are
    16-byte aligned."""
    if any(t is not None and t.data_ptr() % 16 for t in (x, residual)):
        raise ValueError(f"{what} reads x and the residual in 16-byte "
                         f"vectors: their addresses must be 16-byte aligned")
    for t in tensors:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{what} operands must share {x.device}, got "
                             f"one on {t.device}")
        if t.dtype not in (torch.float32, torch.int64, x.dtype):
            raise TypeError(f"{what}: unexpected operand dtype {t.dtype}")


def bn_act_fwd_cuda(x: torch.Tensor, bn, *, slope=None, residual=None,
                    epi: int = _EPI_NONE):
    """The forward kernels on a CUDA ``x``: the batch statistics pass
    (training) and the apply pass.  Returns ``(out, stats)``, stats the
    (2, C) f32 mean and invstd the backward reads."""
    global BN_ACT_FWD_LAUNCHES, BN_ACT_FWD_F32_LAUNCHES
    from torchsr_tpu_torch.ops._build import load_library

    params = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    if any(p.dtype != torch.float32 or not p.is_contiguous()
           for p in params):
        raise TypeError("bn_act_fwd_cuda takes the BatchNorm's parameters "
                        "and statistics in contiguous float32")
    _cuda_tensors(x, (*params, bn.num_batches_tracked, slope, residual),
                  "bn_act_fwd_cuda", residual=residual)
    c = x.shape[-1]
    rows = x.numel() // c
    train = bool(bn.training)
    if train and rows < 2:
        raise ValueError("bn_act needs more than one value per channel in "
                         "training mode")
    ctas, rpb = bn_act_grid(rows, c)
    dev = x.device
    y = torch.empty_like(x)
    part = torch.empty((ctas, 2, c), dtype=torch.float32, device=dev)
    stats = torch.empty((2, c), dtype=torch.float32, device=dev)
    lib = load_library("bn_act")
    err = lib.bn_act_fwd_launch(
        int(x.dtype == torch.bfloat16), epi, int(train), x.data_ptr(),
        None if residual is None else residual.data_ptr(), y.data_ptr(),
        bn.weight.data_ptr(), bn.bias.data_ptr(),
        None if slope is None else slope.data_ptr(),
        bn.running_mean.data_ptr(), bn.running_var.data_ptr(),
        bn.num_batches_tracked.data_ptr(), part.data_ptr(),
        stats.data_ptr(), rows, c, ctas, rpb, float(bn.eps),
        float(bn.momentum), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib.bn_act_error_string, "bn_act forward")
    if x.dtype == torch.float32:
        BN_ACT_FWD_F32_LAUNCHES += 1
    else:
        BN_ACT_FWD_LAUNCHES += 1
    return y, stats


def bn_act_bwd_cuda(x: torch.Tensor, g: torch.Tensor, weight, bias, stats,
                    *, slope=None, epi: int = _EPI_NONE, train: bool = True):
    """The backward kernels on CUDA: the reduction pass and the dx pass.
    Returns ``(dx, dweight, dbias, dslope)``: dx in x's dtype, the rest in
    f32 (dslope None without a PReLU)."""
    global BN_ACT_BWD_LAUNCHES, BN_ACT_BWD_F32_LAUNCHES
    from torchsr_tpu_torch.ops._build import load_library

    if g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous():
        raise ValueError(f"bn_act_bwd_cuda takes a contiguous {x.dtype} "
                         f"gradient of x's shape {tuple(x.shape)}")
    _cuda_tensors(x, (g, weight, bias, stats, slope), "bn_act_bwd_cuda")
    if g.data_ptr() % 16:
        g = g.clone()
    c = x.shape[-1]
    rows = x.numel() // c
    ctas, rpb = bn_act_grid(rows, c)
    dev = x.device
    dx = torch.empty_like(x)
    part = torch.empty((ctas, 2 * c + 1), dtype=torch.float32, device=dev)
    dw = torch.empty((c,), dtype=torch.float32, device=dev)
    db = torch.empty((c,), dtype=torch.float32, device=dev)
    ds = (None if slope is None
          else torch.empty((1,), dtype=torch.float32, device=dev))
    lib = load_library("bn_act")
    err = lib.bn_act_bwd_launch(
        int(x.dtype == torch.bfloat16), epi, int(train), x.data_ptr(),
        g.data_ptr(), dx.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if slope is None else slope.data_ptr(), stats.data_ptr(),
        part.data_ptr(), dw.data_ptr(), db.data_ptr(),
        None if ds is None else ds.data_ptr(), rows, c, ctas, rpb,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, lib.bn_act_error_string, "bn_act backward")
    if x.dtype == torch.float32:
        BN_ACT_BWD_F32_LAUNCHES += 1
    else:
        BN_ACT_BWD_LAUNCHES += 1
    return dx, dw, db, ds


def bn_act_formulas(x: torch.Tensor, bn, *, slope=None, residual=None,
                    dy: torch.Tensor | None = None,
                    drop: str | None = None) -> dict:
    """The kernels' formulas restated in float64 from ``bn``'s state (not
    changed), rounding to x's dtype where the composition rounds: ``y``,
    in training ``running_mean`` and ``running_var`` as they would move,
    and with ``dy`` also ``dx`` (x's dtype), ``dweight``, ``dbias`` and
    ``dslope`` (f64; dslope rounded to x's dtype), each sum with the sum
    of its terms' magnitudes (``dweight_abs``, ``dbias_abs``,
    ``dslope_abs``), which bounds its rounding.  ``drop="dzx"`` leaves
    the xhat * mean(dz * xhat) term out of dx: what a wrong kernel
    computes."""
    dt, c = x.dtype, x.shape[-1]

    def rnd(t):
        return t.to(dt).double()

    xd = x.detach().double().reshape(-1, c)
    gamma, beta = bn.weight.detach().double(), bn.bias.detach().double()
    out: dict = {}
    if bn.training:
        mean, var = xd.mean(0), xd.var(0, unbiased=False)
        m = bn.momentum
        out["running_mean"] = (1 - m) * bn.running_mean.double() + m * mean
        out["running_var"] = ((1 - m) * bn.running_var.double()
                              + m * xd.var(0, unbiased=True))
    else:
        mean, var = bn.running_mean.double(), bn.running_var.double()
    invstd = 1.0 / torch.sqrt(var + bn.eps)
    xhat = (xd - mean) * invstd
    z = rnd(xhat * gamma + beta)
    if slope is not None:
        a = rnd(slope.detach().double())
        y = torch.where(z >= 0, z, rnd(a * z))
    elif residual is not None:
        y = rnd(z + residual.detach().double().reshape(-1, c))
    else:
        y = z
    out["y"] = y.to(dt).reshape(x.shape)
    if dy is None:
        return out
    g = dy.detach().double().reshape(-1, c)
    dz = g
    if slope is not None:
        neg = ~(z >= 0)
        dz = torch.where(neg, rnd(g * a), g)
        terms = torch.where(neg, rnd(g * z), 0.0)
        out["dslope"] = rnd(terms.sum()).reshape(1)
        out["dslope_abs"] = terms.abs().sum().reshape(1)
    out["dbias"], out["dweight"] = dz.sum(0), (dz * xhat).sum(0)
    out["dbias_abs"], out["dweight_abs"] = (dz.abs().sum(0),
                                            (dz * xhat).abs().sum(0))
    if bn.training:
        dxhat = dz - dz.mean(0)
        if drop != "dzx":
            dxhat = dxhat - xhat * (dz * xhat).mean(0)
    else:
        dxhat = dz
    out["dx"] = (invstd * gamma * dxhat).to(dt).reshape(x.shape)
    return out
