#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ESRGAN serving path once on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py [--seed N]

Phases, one line each:

1. probe: requires a CUDA device; prints its name and power limit.
2. build: compiles ``torchsr_tpu_torch/ops/csrc/rdb_fwd.cu`` with nvcc.
3. rdb_fwd: the RDB kernel at the serving shape (16 tiles of 64x64, 64
   channels) and at a ragged shape, in f32 and bf16.  Each of its five
   launches is held against its own convolution of the feature buffer
   the kernel filled, and the block against its plain PyTorch version;
   each check also prints what a wrong kernel reads under its limit.
   Median times over 30 calls (CUDA events) beside the card's bound.
4. generator: the full-width 23-RRDB ESRGAN (seeded random weights) on
   one tile batch, kernel path against plain path in f32 and in bf16,
   both timed in bf16, and a ``profile`` line: ``torch.profiler``'s
   device time per kernel class over three tile batches.
5. serve, the main path: the weights saved as a .pth,
   ``CheckpointUpscaleService`` on ``cuda`` behind ``make_server``, three
   PNG requests over HTTP.  The kernel's launch counter is reset just
   before the requests and must read 5 x 69 x the tile batches run; the
   answers are held against the same tiling of the generator.
6. test: ``python -m torchsr_tpu_torch test`` (called in this process)
   on one image, whole-image and tiled, the counter reset before each.

Then a ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no last line.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from torchsr_tpu_torch import cli  # noqa: E402
from torchsr_tpu_torch.infer.server import (  # noqa: E402
    CheckpointUpscaleService,
    make_server,
)
from torchsr_tpu_torch.infer.tiled import _positions, tiled_upscale  # noqa: E402
from torchsr_tpu_torch.models.esrgan import (  # noqa: E402
    ESRGANGenerator,
    ResidualDenseBlock,
)
from torchsr_tpu_torch.models.layers import leaky_relu  # noqa: E402
from torchsr_tpu_torch.ops import _build  # noqa: E402
from torchsr_tpu_torch.ops import rdb as rdb_ops  # noqa: E402
from torchsr_tpu_torch.ops.resize import nearest_upsample  # noqa: E402
from torchsr_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
)

# H100 SXM published peaks (dense): the bound of a kernel is the larger
# of its bytes over HBM bandwidth and its operations over the peak rate
# of their type.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
RDB_FLOP_PER_PX = 2 * 9 * sum(
    ci * co for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)
)  # 479,232
SERVE_RDB_SHAPE = (16, 64, 64, 64)  # tile_batch 16 of 64 px LR tiles
RAGGED = (3, 37, 45)  # partial CTA tiles, as the whole-image `test` gives
SCALE = 0.2  # the blocks' residual scale
NUM_RRDB = 23
# Per-element limits.  A result passes when at every element
#     |got - ref| <= rel * |ref| + frac * max|ref - base|,
# where max|ref - base| is the largest value the checked computation
# adds: a launch's output (base 0), or the block's residual
# scale * conv5 (base x).  "excess" is the largest ratio of the left
# side to the right, and at most 1 passes.  Beside each, the excess of
# a wrong result is printed (a grown slice left at zero, conv5 skipped):
# it must exceed 1, or the limit could not see that fault.
#
# A launch against the same convolution (f32, TF32 off) of the feature
# buffer the kernel itself filled.  f32 differs in summation order only
# (~1e-7 of the values); bf16 also rounds once to bf16, at most 2^-8 of
# the value, and rel 2^-7 allows a tie rounded the other way.
STAGE_LIMITS = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2**-7, 1e-3)}
# The block against its plain version in f32 on the same inputs.  In
# bf16 the four rounded intermediates (2^-9 of their values on average)
# also feed conv5, so frac is 2^-5 of the largest residual.
BLOCK_LIMITS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2**-7, 2**-5)}
# The whole generator in f32, kernel path against plain path on the
# same weights: 351 convs summed in other orders.  Limits on the
# generator are fractions of the largest output value of its f32 plain
# path.
TOL_GEN_F32 = 1e-5
# The generator in bf16 against that f32 plain path.  At the model's
# own init (RDB kernels kaiming-normal x 0.1) what the blocks add to the
# output is of the order of the bf16 rounding of the input and of the
# other convs, so this limit bounds gross errors only.  With the
# blocks' convs at torch's default init they add more, and there the
# bf16 kernel path is also held against the bf16 plain path (the same
# rounding of the input and of the other convs) to a fraction of what
# a generator with wrong blocks reads against the f32 plain path.
TOL_GEN_BF16 = 0.05
GEN_BF16_FRAC = 0.25
# The RDB backward kernel (B2) at the training shape: batch 64 of 128 px
# HR crops, so 32 x 32 LR pixels through the generator's blocks.
TRAIN_RDB_SHAPE = (64, 32, 32, 64)
# One backward is a dgrad and a wgrad per conv: twice the forward's
# operations.
RDB_BWD_FLOP_PER_PX = 2 * RDB_FLOP_PER_PX
# Each stage of the backward against the same computation (f32, TF32
# off) of the kernel's own inputs to that stage: dW_i and db_i from the
# da_i its dense gradient gives, and each slice of its dense gradient
# from the dgrads of those da_i.  The products of working-dtype
# operands are exact in f32 in both, so f32 and bf16 differ in summation
# order only: sums of 65,536 pixels (dW, db) or 288-1,728 products (dF).
BWD_STAGE_LIMITS = {torch.float32: (1e-4, 1e-4),
                    torch.bfloat16: (1e-4, 1e-4)}
# dx against dF[..., :64] + g rounded once to the working dtype (the
# same f32 sum): exact, so rel 2^-9 is under half the smallest bf16 step.
DX_LIMITS = (2**-9, 1e-6)
# The whole backward against rdb_bwd_reference on the same inputs.  In
# bf16 a dense-gradient value that lands on the other side of a rounding
# step rounds the next conv's dy one step (2^-8) apart.
BWD_BLOCK_LIMITS = {torch.float32: (1e-4, 1e-4),
                    torch.bfloat16: (2**-7, 2**-6)}
# The wrong backward kernels each limit must see (emulated in plain
# PyTorch): conv 3's dW left at zero, LeakyReLU' taken as 1, the dgrad
# taps not flipped, conv5's dense gradient not passed to convs 1-4.
WRONG_BWD = ("dw3_zero", "lrelu_one", "taps_unflipped", "conv5_dropped")
# train_grad: one L1 backward of the 23-RRDB generator, every parameter
# gradient of the kernel path against the plain path (autograd through
# rdb_reference), as max|kernel - plain| / max|plain| per tensor.
TRAIN_GRAD_BATCH = 4
TOL_GRAD = {torch.float32: 1e-3, torch.bfloat16: 0.1}
# A served frame against the same tiling of the generator, both rounded
# to uint8: the same computation, so at most a rounding tie apart.
TOL_SERVE_LEVELS = 1
REQUEST_SIZES = ((64, 64), (128, 160), (120, 200))
# train, the main path: seeded random PNGs, split 90/10 by the CLI
# (36 train, 4 eval), one pretrain and one GAN epoch at batch 16, the
# full-width generator (23 RRDBs) and the full VGG19 trunk, bf16.
TRAIN_IMAGES = 40
TRAIN_IMAGE_HW = (160, 160)
TRAIN_BATCH = 16
SAMPLE_HW = (48, 64)  # the per-epoch progress sample's LR size
# Step times are also taken at the JAX package's default batch.
SPEED_BATCHES = (16, 64)
SPEED_STEPS = 5
TEST_IMAGE = (100, 140)
DEVICE = "cuda"


def say(phase: str, **fields) -> None:
    print(f"{phase}: {json.dumps(fields)}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def rdb_bound_ms(shape, dtype) -> tuple[float, str]:
    b, h, w, c = shape
    px = b * h * w
    item = torch.finfo(dtype).bits // 8
    weights = sum(9 * ci * co for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT))
    nbytes = 2 * px * c * item + weights * item + 4 * sum(rdb_ops.COUT)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = px * RDB_FLOP_PER_PX / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes > t_ops else "operations")


def excess(got, ref, limits, base=None) -> float:
    """The largest ratio |got - ref| / (rel |ref| + frac max|ref - base|)
    over the elements (0 where both sides agree exactly); at most 1
    passes."""
    rel, frac = limits
    got, ref = got.float(), ref.float()
    if base is not None:
        base = base.float()
    scale = (ref if base is None else ref - base).abs().max()
    diff = (got - ref).abs()
    ratio = diff / (rel * ref.abs() + frac * scale)
    return float(torch.where(diff == 0, 0.0, ratio).max())


def conv3x3(f: torch.Tensor, k: torch.Tensor, b: torch.Tensor):
    """SAME 3x3 conv of NHWC ``f`` by HWIO ``k``, in ``f.dtype``."""
    return F.conv2d(f.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(f.dtype),
                    b.to(f.dtype), padding=1).permute(0, 2, 3, 1)


def conv5_skipped(y, kernels, biases, *, scale_ratio):
    """A wrong block that lost its residual: it returns its input."""
    return y


def grown_zero(y, kernels, biases, *, scale_ratio):
    """A wrong block whose launches 1-4 wrote zeros: conv5 sees x only."""
    grown = rdb_ops.FEAT - rdb_ops.CHANNELS
    return y + scale_ratio * conv3x3(F.pad(y, (0, grown)), kernels[4],
                                     biases[4])


WRONG_BLOCKS = {"conv5_skipped": conv5_skipped, "grown_zero": grown_zero}


def emulated_bwd(g, feat, kernels, scale_ratio, fault=None):
    """The arithmetic of ``rdb_bwd.cu`` in plain PyTorch, optionally with
    one of the ``WRONG_BWD`` faults: (dx, dws, dbs, dfeat) as
    ``rdb_bwd_cuda`` returns them."""
    dt = feat.dtype
    f = feat.permute(0, 3, 1, 2).float()
    dfeat = torch.zeros_like(f)
    da = g.permute(0, 3, 1, 2).float() * scale_ratio
    dws, dbs = [None] * 5, [None] * 5
    for i in reversed(range(5)):
        cin = rdb_ops.CIN[i]
        if i < 4:
            s = rdb_ops._slot(i)
            deriv = (1.0 if fault == "lrelu_one"
                     else 0.2 + 0.8 * (f[:, s] > 0).float())
            da = dfeat[:, s] * deriv
        dy = da.to(dt).float()
        k = kernels[i].to(dt).float()
        w = k.permute(3, 2, 0, 1)
        dbs[i] = da.sum(dim=(0, 2, 3))
        dws[i] = torch.nn.grad.conv2d_weight(
            f[:, :cin], w.shape, dy, padding=1).permute(2, 3, 1, 0)
        if fault == "dw3_zero" and i == 2:
            dws[i] = torch.zeros_like(dws[i])
        wd = k.flip(0, 1).permute(3, 2, 0, 1) if fault == "taps_unflipped" \
            else w
        if not (fault == "conv5_dropped" and i == 4):
            dfeat[:, :cin] += torch.nn.grad.conv2d_input(
                f[:, :cin].shape, wd, dy, padding=1)
    dx = (dfeat[:, :rdb_ops.CHANNELS]
          + g.permute(0, 3, 1, 2).float()).to(dt)
    return (dx.permute(0, 2, 3, 1), tuple(dws), tuple(dbs),
            dfeat.permute(0, 2, 3, 1))


def _dfeat_slices():
    """(name, channel slice) of each stage's part of the dense gradient:
    x's 64 channels (dx - g), then the four grown slices."""
    return [("x", slice(0, rdb_ops.CHANNELS))] + [
        (f"y{i + 1}", rdb_ops._slot(i)) for i in range(4)]


def bwd_scores(g, feat, kernels, got, scale_ratio=SCALE) -> dict:
    """Excess of each stage of a backward ``got`` = (dx, dws, dbs,
    dfeat) against the same computation of its own inputs, and of the
    whole against ``rdb_bwd_reference`` (see the limits above)."""
    dt = feat.dtype
    dx, dws, dbs, dfeat = got
    f = feat.permute(0, 3, 1, 2).float()
    dF = dfeat.permute(0, 3, 1, 2).float()
    stage_ref = torch.zeros_like(dF)
    da = g.permute(0, 3, 1, 2).float() * scale_ratio
    limits = BWD_STAGE_LIMITS[dt]
    dw_ex, db_ex = [None] * 5, [None] * 5
    for i in reversed(range(5)):
        cin = rdb_ops.CIN[i]
        if i < 4:  # da_i from the kernel's own dense gradient
            s = rdb_ops._slot(i)
            da = dF[:, s] * (0.2 + 0.8 * (f[:, s] > 0).float())
        dy = da.to(dt).float()
        w = kernels[i].to(dt).float().permute(3, 2, 0, 1)
        ref_dw = torch.nn.grad.conv2d_weight(
            f[:, :cin], w.shape, dy, padding=1).permute(2, 3, 1, 0)
        dw_ex[i] = excess(dws[i], ref_dw, limits)
        db_ex[i] = excess(dbs[i], da.sum(dim=(0, 2, 3)), limits)
        stage_ref[:, :cin] += torch.nn.grad.conv2d_input(
            f[:, :cin].shape, w, dy, padding=1)
    stage_ref = stage_ref.permute(0, 2, 3, 1)
    dfeat_ex = {name: excess(dfeat[..., sl], stage_ref[..., sl], limits)
                for name, sl in _dfeat_slices()}
    dx_ref = (dfeat[..., :rdb_ops.CHANNELS] + g.float()).to(dt).float()
    ref = rdb_ops.rdb_bwd_reference(g, feat, kernels, scale_ratio,
                                     return_dfeat=True)
    limits = BWD_BLOCK_LIMITS[dt]
    block = {f"dw{i + 1}": excess(dws[i], ref[1][i], limits)
             for i in range(5)}
    block.update({f"db{i + 1}": excess(dbs[i], ref[2][i], limits)
                  for i in range(5)})
    block.update({f"dfeat_{name}": excess(dfeat[..., sl], ref[3][..., sl],
                                          limits)
                  for name, sl in _dfeat_slices()})
    return {
        "max_abs_err": float((dx.float() - ref[0].float()).abs().max()),
        "stage_dw": dw_ex, "stage_db": db_ex, "stage_dfeat": dfeat_ex,
        "dx": excess(dx.float(), dx_ref, DX_LIMITS),
        "block": block,
    }


def _worst(row: dict) -> float:
    """The largest excess of a ``bwd_scores`` row."""
    return max(*row["stage_dw"], *row["stage_db"],
               *row["stage_dfeat"].values(), row["dx"],
               *row["block"].values())


def plain_generator(gen: ESRGANGenerator, x: torch.Tensor,
                    block=rdb_ops.rdb_reference) -> torch.Tensor:
    """The generator's forward with every residual dense block on
    ``block`` (by default the plain version, five cuDNN convolutions)
    instead of the kernel."""
    x = x.to(gen.compute_dtype or torch.float32)
    conv1 = gen.conv1(x).contiguous()
    out = conv1
    for rrdb in gen.blocks:
        y = out
        for rdb in (rrdb.RDB1, rrdb.RDB2, rrdb.RDB3):
            convs = rdb.convs()
            y = block(y, [c.weight.permute(2, 3, 1, 0) for c in convs],
                      [c.bias for c in convs], scale_ratio=rdb.scale_ratio)
        out = y * rrdb.scale_ratio + out
    out = conv1 + gen.conv2(out)
    for up in gen.upsamplers():
        out = leaky_relu(up(nearest_upsample(out, 2)), 0.2)
    out = leaky_relu(gen.conv3[0](out), 0.2)
    return gen.conv4(out).float()


def phase_probe() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
            "is False"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("probe", device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)


def phase_build() -> None:
    """Both kernels' sources, one nvcc each, started together."""
    t0 = time.perf_counter()
    built = _build.build_all()
    report = {}
    for lib, info in built.items():
        regs, name = [], None
        for line in info["ptxas"]:
            m = re.search(r"entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                t = re.search(r"(\w+?)_(bf16|f32)ILi(\d+)ELi(\d+)E", name)
                if t:
                    name = (f"{t.group(1)[-6:]}_{t.group(2)}/{t.group(3)}"
                            f"->{t.group(4)}")
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(f"{name}:{m.group(1)}r")
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and m.group(1) != "0":
                regs.append(f"{name}:SPILL{m.group(1)}")
        report[lib] = {"nvcc_seconds": round(info["seconds"], 3),
                       "ptxas": regs}
    for lib in _build.SIGNATURES:
        _build.load_library(lib)
    say("build", seconds=round(time.perf_counter() - t0, 3), **report)


def _rdb_weights(gen: torch.Generator, device):
    convs = ResidualDenseBlock().convs()
    for conv in convs:
        conv.reset_parameters(gen)
    ks = [c.weight.detach().permute(2, 3, 1, 0).contiguous().to(device)
          for c in convs]
    bs = [c.bias.detach().to(device) for c in convs]
    return ks, bs


def hold_rdb(x: torch.Tensor, ks, bs) -> dict:
    """One ``fused_rdb`` on the card, each launch and the whole block
    held against plain convolutions in f32 (see the limits above)."""
    before = rdb_ops.RDB_FWD_LAUNCHES
    out, feat = rdb_ops.rdb_fwd_cuda(x, ks, bs, scale_ratio=SCALE)
    check(rdb_ops.RDB_FWD_LAUNCHES == before + 5,
          "fused_rdb launched its kernel five times")
    check(bool(torch.isfinite(out).all()), "rdb_fwd output finite")
    row = rdb_scores(x, ks, bs, out, feat)
    name = f"rdb_fwd {x.dtype} {tuple(x.shape)}"
    check(max(row["stage_excess"]) <= 1 and row["block_excess"] <= 1,
          f"{name} within its limits: {row}")
    check(min(row["stage_wrong_excess"]) > 1
          and min(row["block_wrong_excess"].values()) > 1,
          f"{name}: the limits see a wrong kernel: {row}")
    return row


def rdb_scores(x: torch.Tensor, ks, bs, out: torch.Tensor,
               feat: torch.Tensor) -> dict:
    """The excess of each launch of a block (``feat``: the feature
    buffer it filled, ``out``: its output) and of the whole block, and
    of the wrong results beside them."""
    limits = STAGE_LIMITS[x.dtype]
    xf, f, out = x.float(), feat.float(), out.float()
    stages, stages_wrong = [], []
    for i, (cin, cout) in enumerate(zip(rdb_ops.CIN, rdb_ops.COUT)):
        ref = conv3x3(f[..., :cin], ks[i].float(), bs[i])
        if i < 4:  # launch i appended channels [cin, cin + 32)
            ref = F.leaky_relu(ref, 0.2)
            got, wrong, base = f[..., cin:cin + cout], 0 * ref, None
        else:  # launch 5 wrote x + scale * conv5
            ref = xf + SCALE * ref
            got, wrong, base = out, xf, xf
        stages.append(excess(got, ref, limits, base))
        stages_wrong.append(excess(wrong, ref, limits, base))
    limits = BLOCK_LIMITS[x.dtype]
    kf = [k.float() for k in ks]
    ref = rdb_ops.rdb_reference(xf, kf, bs, scale_ratio=SCALE)
    block_wrong = {name: excess(fn(xf, kf, bs, scale_ratio=SCALE), ref,
                                limits, xf)
                   for name, fn in WRONG_BLOCKS.items()}
    return {
        "max_abs_err": float((out - ref).abs().max()),
        "block_excess": excess(out, ref, limits, xf),
        "block_wrong_excess": block_wrong,
        "stage_excess": stages,
        "stage_wrong_excess": stages_wrong,
    }


def phase_rdb(seed: int) -> dict:
    dev = torch.device(DEVICE)
    g = torch.Generator().manual_seed(seed)
    ks, bs = _rdb_weights(g, dev)
    x = (torch.randn(SERVE_RDB_SHAPE, generator=g) * 0.5).to(dev)
    b, h, w = RAGGED
    rows = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            kd = [k.to(dtype) for k in ks]
            row = hold_rdb(xd, kd, bs)
            row["ragged"] = hold_rdb(xd[:b, :h, :w], kd, bs)
            row["ms"] = median_ms(lambda: rdb_ops.fused_rdb(xd, kd, bs))
            row["plain_ms"] = median_ms(
                lambda: rdb_ops.rdb_reference(xd, kd, bs))
            row["bound_ms"], row["bound_by"] = rdb_bound_ms(SERVE_RDB_SHAPE,
                                                            dtype)
            row["tflops"] = (SERVE_RDB_SHAPE[0] * 64 * 64 * RDB_FLOP_PER_PX
                             / row["ms"] / 1e9)
            name = str(dtype).removeprefix("torch.")
            rows[name] = row
            say(f"rdb_fwd[{name}]", shape=list(SERVE_RDB_SHAPE),
                ragged_shape=[*RAGGED, 64], stage_limits=STAGE_LIMITS[dtype],
                block_limits=BLOCK_LIMITS[dtype], **row)
    return rows


def rdb_bwd_bound_ms(shape, dtype) -> tuple[float, str]:
    """The backward's bound: reads feat, g and the kernels once, writes
    dx, dW and db once; dgrad + wgrad operations."""
    b, h, w, c = shape
    px = b * h * w
    item = torch.finfo(dtype).bits // 8
    weights = sum(9 * ci * co for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT))
    nbytes = (px * (rdb_ops.FEAT + 2 * c) * item + weights * (item + 4)
              + 4 * sum(rdb_ops.COUT))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = px * RDB_BWD_FLOP_PER_PX / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes > t_ops else "operations")


def hold_rdb_bwd(x: torch.Tensor, ks, bs, g: torch.Tensor) -> dict:
    """One backward kernel run on the feature buffer the forward kernel
    filled from ``x``; every stage and the whole held against plain
    computations, beside what the ``WRONG_BWD`` kernels read."""
    _, feat = rdb_ops.rdb_fwd_cuda(x, ks, bs, scale_ratio=SCALE)
    before = rdb_ops.RDB_BWD_LAUNCHES
    got = rdb_ops.rdb_bwd_cuda(g, feat, ks, scale_ratio=SCALE)
    torch.cuda.synchronize()
    check(rdb_ops.RDB_BWD_LAUNCHES == before + 1,
          "rdb_bwd_cuda counted one backward")
    check(all(bool(torch.isfinite(t).all())
              for t in (got[0], *got[1], *got[2], got[3])),
          "rdb_bwd outputs finite")
    row = bwd_scores(g, feat, ks, got)
    row["worst"] = _worst(row)
    row["wrong"] = {fault: _worst(bwd_scores(
        g, feat, ks, emulated_bwd(g, feat, ks, SCALE, fault)))
        for fault in WRONG_BWD}
    return row


def phase_rdb_bwd(seed: int) -> dict:
    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(seed + 3)
    ks, bs = _rdb_weights(gen, dev)
    x = (torch.randn(TRAIN_RDB_SHAPE, generator=gen) * 0.5).to(dev)
    g = (torch.randn(TRAIN_RDB_SHAPE, generator=gen) * 0.1).to(dev)
    b, h, w = RAGGED
    rows = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            xd, gd = x.to(dtype), g.to(dtype)
            kd = [k.to(dtype) for k in ks]
            row = hold_rdb_bwd(xd, kd, bs, gd)
            row["ragged"] = hold_rdb_bwd(xd[:b, :h, :w], kd, bs,
                                         gd[:b, :h, :w])
            _, feat = rdb_ops.rdb_fwd_cuda(xd, kd, bs, scale_ratio=SCALE)
            row["ms"] = median_ms(
                lambda: rdb_ops.rdb_bwd_cuda(gd, feat, kd, scale_ratio=SCALE))
            row["plain_ms"] = median_ms(
                lambda: rdb_ops.rdb_bwd_reference(gd, feat, kd, SCALE))
            row["bound_ms"], row["bound_by"] = rdb_bwd_bound_ms(
                TRAIN_RDB_SHAPE, dtype)
            px = TRAIN_RDB_SHAPE[0] * TRAIN_RDB_SHAPE[1] * TRAIN_RDB_SHAPE[2]
            row["tflops"] = px * RDB_BWD_FLOP_PER_PX / row["ms"] / 1e9
            name = str(dtype).removeprefix("torch.")
            rows[name] = row
            say(f"rdb_bwd[{name}]", shape=list(TRAIN_RDB_SHAPE),
                ragged_shape=[*RAGGED, 64],
                stage_limits=BWD_STAGE_LIMITS[dtype], dx_limits=DX_LIMITS,
                block_limits=BWD_BLOCK_LIMITS[dtype], **row)
            for r, where in ((row, "training"), (row["ragged"], "ragged")):
                check(r["worst"] <= 1,
                      f"rdb_bwd {name} {where} within its limits")
                check(min(r["wrong"].values()) > 1,
                      f"rdb_bwd {name} {where}: the limits see every "
                      f"wrong kernel: {r['wrong']}")
    return rows


class _WrongBwdBlock(torch.autograd.Function):
    """The plain block forward with the emulated backward carrying one
    of the ``WRONG_BWD`` faults."""

    @staticmethod
    def forward(ctx, x, fault, *params):
        ks, bs = params[:5], params[5:]
        out, feat = rdb_ops._rdb_plain(x, ks, bs, SCALE)
        ctx.fault = fault
        ctx.save_for_backward(feat, *ks)
        return out

    @staticmethod
    def backward(ctx, g):
        feat, *ks = ctx.saved_tensors
        dx, dws, dbs, _ = emulated_bwd(g, feat, ks, SCALE, ctx.fault)
        return (dx, None, *[d.to(k.dtype) for d, k in zip(dws, ks)], *dbs)


def _rel_grads(got, ref) -> list:
    return [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(got, ref)]


def phase_train_grad(seed: int) -> dict:
    """One L1 backward of the full generator: the kernel path's gradient
    of every parameter against the plain path's, in f32 and bf16."""
    dev = torch.device(DEVICE)
    gen = ESRGANGenerator(
        num_rrdb_blocks=NUM_RRDB,
        generator=torch.Generator().manual_seed(seed + 5)).to(dev)
    g = torch.Generator().manual_seed(seed + 6)
    x = torch.rand((TRAIN_GRAD_BATCH, 32, 32, 3), generator=g).to(dev)
    hr = torch.rand((TRAIN_GRAD_BATCH, 128, 128, 3), generator=g).to(dev)
    names, params = zip(*gen.named_parameters())

    def grads(fn):
        loss = (fn(x) - hr).abs().mean()
        return torch.autograd.grad(loss, params)

    def wrong(y, kernels, biases, *, scale_ratio):
        return _WrongBwdBlock.apply(y, "lrelu_one", *kernels, *biases)

    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        gen.compute_dtype = None if dtype == torch.float32 else dtype
        fwd0, bwd0 = rdb_ops.RDB_FWD_LAUNCHES, rdb_ops.RDB_BWD_LAUNCHES
        got = grads(gen)
        torch.cuda.synchronize()
        launches = (rdb_ops.RDB_FWD_LAUNCHES - fwd0,
                    rdb_ops.RDB_BWD_LAUNCHES - bwd0)
        ref = grads(lambda t: plain_generator(gen, t))
        bad = grads(lambda t: plain_generator(gen, t, wrong))
        rel, rel_wrong = _rel_grads(got, ref), _rel_grads(bad, ref)
        worst = max(range(len(rel)), key=rel.__getitem__)
        name = str(dtype).removeprefix("torch.")
        rows[name] = row = {
            "launches_fwd_bwd": list(launches),
            "max_rel": rel[worst], "worst_param": names[worst],
            "wrong_lrelu_one_max_rel": max(rel_wrong),
            "limit": TOL_GRAD[dtype],
            "rdb_params_max_rel": max(r for n, r in zip(names, rel)
                                      if ".RDB" in n),
            "other_params_max_rel": max(r for n, r in zip(names, rel)
                                        if ".RDB" not in n),
        }
        say(f"train_grad[{name}]", batch=TRAIN_GRAD_BATCH, rrdb=NUM_RRDB,
            **row)
        check(launches == (5 * 3 * NUM_RRDB, 3 * NUM_RRDB),
              f"train_grad {name}: one kernel forward and backward per "
              f"block: {launches}")
        check(row["max_rel"] <= TOL_GRAD[dtype],
              f"train_grad {name}: gradients within {TOL_GRAD[dtype]}")
        check(row["wrong_lrelu_one_max_rel"] > TOL_GRAD[dtype],
              f"train_grad {name}: the limit sees a wrong backward")
    gen.compute_dtype = None
    return rows


_RDB_BWD_KERNELS = ("wgrad_bf16", "wgrad_f32", "dgrad_bf16", "dgrad_f32",
                    "reduce_partials", "::prep<")


def _kernel_class(name: str) -> str:
    if "conv3x3_bf16" in name or "conv3x3_f32" in name:
        return "rdb_fwd"
    if any(k in name for k in _RDB_BWD_KERNELS):
        return "rdb_bwd"
    low = name.lower()
    if "multi_tensor_apply" in low or "adam" in low:
        return "optimizer"
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "gemm",
                              "sm90_", "cutlass", "wgrad", "dgrad")):
        return "other_conv"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copy"
    if "elementwise" in low or "vectorized" in low or "reduce" in low:
        return "elementwise"
    return "other"


def profile_device_time(fn, batches: int = 3) -> dict:
    """Device time per kernel class over ``batches`` calls of ``fn``,
    and the device's busy share of the span from the first kernel to
    the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(bool(spans), "the profiler recorded device events")
    by_class: dict = {}
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, name in spans:
        cls = _kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + (end - start) / 1e3
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    total = sum(by_class.values())
    return {
        "batches": batches,
        "device_ms_per_batch": {k: v / batches for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        "share": {k: v / total for k, v in by_class.items()},
        "kernels_per_batch": len(spans) / batches,
        "busy_share_of_span": busy / (spans[-1][1] - spans[0][0]),
    }


def _dist(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a - b).abs()
    return {"max": float(d.max()), "mean": float(d.mean())}


def hold_generator(gen: ESRGANGenerator, x: torch.Tensor) -> dict:
    """The generator's kernel path in f32 and bf16 against its plain
    path in f32, and what generators with wrong blocks read there (max
    and mean absolute differences)."""
    with torch.inference_mode():
        gen.compute_dtype = None
        out = gen(x)
        check(tuple(out.shape) == (x.shape[0], 256, 256, 3),
              "generator 4x shape")
        check(bool(torch.isfinite(out).all()), "generator output finite")
        ref = plain_generator(gen, x)
        row = {"f32_vs_f32_plain": _dist(out, ref)}
        gen.compute_dtype = torch.bfloat16
        out = gen(x)
        row["bf16_vs_f32_plain"] = _dist(out, ref)
        row["bf16_vs_bf16_plain"] = _dist(out, plain_generator(gen, x))
        gen.compute_dtype = None
        row["wrong_block_vs_f32_plain"] = {
            name: _dist(plain_generator(gen, x, fn), ref)
            for name, fn in WRONG_BLOCKS.items()}
    scale = float(ref.abs().max())
    row["f32_limit"] = TOL_GEN_F32 * scale
    row["bf16_limit"] = TOL_GEN_BF16 * scale
    row["out_range"] = [float(ref.min()), float(ref.max())]
    check(row["f32_vs_f32_plain"]["max"] <= row["f32_limit"],
          f"generator f32: {row}")
    check(min(d["max"] for d in row["wrong_block_vs_f32_plain"].values())
          > row["f32_limit"],
          f"the f32 limit sees a generator with wrong blocks: {row}")
    check(row["bf16_vs_f32_plain"]["max"] <= row["bf16_limit"],
          f"generator bf16: {row}")
    return row


def phase_generator(seed: int, rdb_bf16_ms: float) -> ESRGANGenerator:
    dev = torch.device(DEVICE)
    gen = ESRGANGenerator(
        num_rrdb_blocks=NUM_RRDB, generator=torch.Generator().manual_seed(seed)
    ).to(dev).requires_grad_(False)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.rand((16, 64, 64, 3), generator=g).to(dev)
    rows = {"model_init": hold_generator(gen, x)}
    # the same generator with the blocks' convs at torch's default init
    visible = ESRGANGenerator(num_rrdb_blocks=NUM_RRDB, device="meta")
    visible.load_state_dict({k: v.clone() for k, v in
                             gen.state_dict().items()}, assign=True)
    for m in visible.blocks.modules():
        if isinstance(m, ResidualDenseBlock):
            for conv in m.convs():
                conv.kernel_std = None
                conv.reset_parameters(g)
    rows["rdb_default_init"] = row = hold_generator(
        visible.requires_grad_(False), x)
    del visible
    row["bf16_vs_bf16_plain_mean_limit"] = limit = GEN_BF16_FRAC * min(
        d["mean"] for d in row["wrong_block_vs_f32_plain"].values())
    check(row["bf16_vs_bf16_plain"]["mean"] <= limit,
          f"generator bf16 within {GEN_BF16_FRAC} of a wrong block: {row}")
    with torch.inference_mode():
        gen.compute_dtype = torch.bfloat16
        ms = median_ms(lambda: gen(x), reps=5, warmup=1)
        plain_ms = median_ms(lambda: plain_generator(gen, x), reps=5,
                             warmup=1)
        prof = profile_device_time(lambda: gen(x))
    say("generator", rrdb=NUM_RRDB, params=sum(p.numel()
                                               for p in gen.parameters()),
        tile_batch=list(x.shape), **rows, bf16_ms=ms,
        bf16_plain_ms=plain_ms,
        bf16_output_mp_per_s=x.shape[0] * 256 * 256 / 1e6 / (ms / 1e3),
        # the 3 * 23 residual dense blocks at the rdb_fwd phase's time
        rdb_share_of_bf16_ms=3 * NUM_RRDB * rdb_bf16_ms / ms)
    say("profile", tile_batch=list(x.shape), dtype="bfloat16", **prof)
    return gen


def _png(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _unpng(body: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)))


def _levels(a: np.ndarray, b: np.ndarray) -> dict:
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"mean": float(diff.mean()), "max": int(diff.max())}


def phase_serve(gen: ESRGANGenerator, ckpt: str, seed: int) -> int:
    service = CheckpointUpscaleService(model="esrgan", checkpoint=ckpt,
                                       device=DEVICE)
    t0 = time.perf_counter()
    server = make_server(service, port=0)
    warmup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in REQUEST_SIZES]
    bodies = [_png(f) for f in frames]
    tile, batch = service.tile, service.tile_batch
    overlap = service._resolve_overlap(None)
    batches = 0
    latencies = []
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            check(resp.status == 200, "/healthz 200 after warmup")
        rdb_ops.RDB_FWD_LAUNCHES = 0  # the main path starts here
        answers = []
        for frame, body in zip(frames, bodies):
            h, w = frame.shape[:2]
            n_tiles = (len(_positions(max(h, tile), tile, tile - overlap))
                       * len(_positions(max(w, tile), tile, tile - overlap)))
            batches += -(-n_tiles // batch)
            req = urllib.request.Request(base + "/upscale", data=body,
                                         method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as resp:
                check(resp.status == 200, "/upscale 200")
                answers.append(_unpng(resp.read()))
            latencies.append((time.perf_counter() - t0) * 1e3)
        launches = rdb_ops.RDB_FWD_LAUNCHES
        with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
            metrics = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    for frame, sr in zip(frames, answers):
        h, w = frame.shape[:2]
        check(sr.shape == (4 * h, 4 * w, 3) and sr.dtype == np.uint8,
              f"answer for {h}x{w} is a {4 * h}x{4 * w} RGB uint8 image")
        check(int(sr.max()) > int(sr.min()), "answer is not constant")
    expected = 5 * 3 * NUM_RRDB * batches
    check(launches == expected,
          f"rdb_fwd launches on the main path {launches} == {expected}")
    check(metrics["requests"] == len(frames) and metrics["errors"] == 0,
          "/metrics counts the requests")

    def tiling(fn, frame):
        x = torch.from_numpy(frame).to(DEVICE).float() / 255.0
        out = tiled_upscale(fn, x, scale=4, tile=tile, overlap=overlap,
                            tile_batch=batch)
        return (out.clamp(0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()

    # each answer against the same tiling of the generator (bf16, the
    # kernel path); the first frame also against the f32 plain
    # generator and against a generator whose blocks lost conv5
    with torch.inference_mode():
        gen.compute_dtype = torch.bfloat16
        vs_direct = [_levels(sr, tiling(gen, f))
                     for f, sr in zip(frames, answers)]
        gen.compute_dtype = None
        ref = tiling(lambda b: plain_generator(gen, b), frames[0])
        wrong = tiling(lambda b: plain_generator(gen, b, conv5_skipped),
                       frames[0])
    say("serve", sizes=[list(s) for s in REQUEST_SIZES],
        warmup_s=warmup_s, request_ms=latencies, tile_batches=batches,
        rdb_fwd_launches=launches, vs_same_tiling_levels=vs_direct,
        first_vs_f32_plain_levels=_levels(answers[0], ref),
        conv5_skipped_vs_f32_plain_levels=_levels(wrong, ref),
        metrics=metrics, meta=service.meta)
    check(max(d["max"] for d in vs_direct) <= TOL_SERVE_LEVELS,
          f"served frames within {TOL_SERVE_LEVELS} level of the "
          f"generator's own tiling: {vs_direct}")
    return launches


def phase_test(ckpt: str, seed: int) -> None:
    """The ``test`` subcommand through the CLI's own ``main``."""
    from PIL import Image

    workdir = os.path.dirname(ckpt)
    frame = np.random.default_rng(seed + 2).integers(
        0, 256, (*TEST_IMAGE, 3), dtype=np.uint8)
    Image.fromarray(frame).save(os.path.join(workdir, "photo.png"))
    h, w = TEST_IMAGE
    overlap = 16  # the test subcommand's default --tile-overlap
    tiles = (len(_positions(h, 64, 64 - overlap))
             * len(_positions(w, 64, 64 - overlap)))
    rows = []
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for extra, batches in (([], 1),
                               (["--tile", "64", "--tile-batch", "16"],
                                -(-tiles // 16))):
            rdb_ops.RDB_FWD_LAUNCHES = 0
            t0 = time.perf_counter()
            cli.main(["test", "photo.png", "--checkpoint", ckpt, *extra])
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = rdb_ops.RDB_FWD_LAUNCHES
            with Image.open("upres-photo.png") as img:
                sr = np.asarray(img)
            check(sr.shape == (4 * h, 4 * w, 3) and sr.max() > sr.min(),
                  f"test {extra} wrote a non-constant {4 * h}x{4 * w} image")
            check(launches == 5 * 3 * NUM_RRDB * batches,
                  f"test {extra}: rdb_fwd launches {launches}")
            rows.append({"args": extra, "wall_ms": wall_ms,
                         "rdb_fwd_launches": launches})
    finally:
        os.chdir(cwd)
    say("test", image=list(TEST_IMAGE), runs=rows)


def _write_png(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr).save(path)


def _finite_metrics(path: str) -> dict:
    """Every loss and quality value the run logged, each required
    finite; returns the last value of each key."""
    last = {}
    with open(path) as fh:
        for line in fh:
            row = json.loads(line)
            for k, v in row.items():
                if k.endswith(("loss", "PSNR", "SSIM")):
                    check(np.isfinite(v), f"{k} = {v} is finite")
                    last[k] = v
    return last


def phase_train(seed: int) -> dict:
    """``python -m torchsr_tpu_torch train`` (in this process) on seeded
    random PNGs, then ``test`` on the GAN phase's best checkpoint."""
    import contextlib
    import shutil

    workdir = os.path.join(ROOT, "build", "chip_smoke", "train")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(os.path.join(workdir, "ds"))
    os.makedirs(os.path.join(workdir, "media"))
    rng = np.random.default_rng(seed)
    for i in range(TRAIN_IMAGES):
        _write_png(os.path.join(workdir, "ds", f"img{i:03d}.png"),
                   rng.integers(0, 256, (*TRAIN_IMAGE_HW, 3), np.uint8))
    _write_png(os.path.join(workdir, "media", "waterfalls-low-res.png"),
               rng.integers(0, 256, (*SAMPLE_HW, 3), np.uint8))
    n_eval = -(-TRAIN_IMAGES // 10)
    steps = (TRAIN_IMAGES - n_eval) // TRAIN_BATCH  # per epoch
    evals = -(-n_eval // TRAIN_BATCH)
    # two epochs (pretrain, GAN): steps run the kernels forward and
    # backward; evals and sample renders forward only
    want_fwd = 5 * 3 * NUM_RRDB * 2 * (steps + evals + 1)
    want_bwd = 3 * NUM_RRDB * 2 * steps
    os.environ["WANDB_MODE"] = "disabled"  # never a network sink
    cwd = os.getcwd()
    os.chdir(workdir)
    log = io.StringIO()
    try:
        rdb_ops.RDB_FWD_LAUNCHES = rdb_ops.RDB_BWD_LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            cli.main(["train", "--train-dir", "ds", "--pretrain-epochs", "1",
                      "--epochs", "1", "--batch-size", str(TRAIN_BATCH),
                      "--seed", str(seed), "--metrics-file", "metrics.jsonl"])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = (rdb_ops.RDB_FWD_LAUNCHES, rdb_ops.RDB_BWD_LAUNCHES)
        text = log.getvalue()
        ckpts = {f"{p}-{k}": os.path.exists(f"esrgan-{p}-{k}.pth")
                 for p in ("psnr", "gan") for k in ("best", "latest")}
        best = load_checkpoint("esrgan-gan-best.pth")
        metrics = _finite_metrics("metrics.jsonl")
        _write_png("photo.png", rng.integers(0, 256, (*TEST_IMAGE, 3),
                                             np.uint8))
        rdb_ops.RDB_FWD_LAUNCHES = 0
        with contextlib.redirect_stdout(log):
            cli.main(["test", "photo.png", "--checkpoint",
                      "esrgan-gan-best.pth"])
        test_launches = rdb_ops.RDB_FWD_LAUNCHES
        with open("upres-photo.png", "rb") as fh:
            sr = _unpng(fh.read())
    finally:
        os.chdir(cwd)
    row = {
        "images": TRAIN_IMAGES, "image_hw": list(TRAIN_IMAGE_HW),
        "batch": TRAIN_BATCH, "steps_per_epoch": steps,
        "eval_batches": evals, "wall_s": wall_s,
        "rdb_fwd_launches": launches[0], "rdb_bwd_launches": launches[1],
        "expected": [want_fwd, want_bwd], "checkpoints": ckpts,
        "gan_best": {"epoch": best["epoch"], "phase": best["phase"],
                     "step": best["extra"]["step"]},
        "metrics": metrics, "test_rdb_fwd_launches": test_launches,
    }
    say("train", **row)
    lines = text.splitlines()
    check(any("RANDOM VGG features" in ln for ln in lines),
          "the random-VGG warning was printed")
    check("Initialized GAN phase from PSNR weights" in lines,
          "the GAN phase started from psnr-latest")
    check(all(ckpts.values()), f"the four checkpoints exist: {ckpts}")
    check(best["phase"] == "esrgan-gan" and best["extra"]["step"]
          == 2 * steps, "gan-best holds the GAN phase's training state")
    check(launches == (want_fwd, want_bwd),
          f"train: kernel launches {launches} == {(want_fwd, want_bwd)}")
    check(test_launches == 5 * 3 * NUM_RRDB, "test ran the kernel once")
    h, w = TEST_IMAGE
    check(sr.shape == (4 * h, 4 * w, 3) and sr.max() > sr.min(),
          "test on the trained checkpoint wrote a 4x non-constant image")
    return row


def phase_train_speed(seed: int) -> dict:
    """Pretrain and GAN step times (host clock around synchronized
    steps) at batch 16 and 64, and a profile of one GAN step at 64."""
    from argparse import Namespace

    from torchsr_tpu_torch.data.loader import initialize_datasets
    from torchsr_tpu_torch.train.trainer import ESRGANTrainer
    from torchsr_tpu_torch.utils.logging import Logger

    ds = os.path.join(ROOT, "build", "chip_smoke", "train", "ds")
    rows = {}
    prof = None
    for batch in SPEED_BATCHES:
        args = Namespace(batch_size=batch, epochs=1, pretrain_epochs=1,
                         seed=seed, skip_image_save=True, disable_amp=False,
                         metrics_file=None)
        trainer = ESRGANTrainer(
            args, *initialize_datasets(ds, batch, 128, seed=seed),
            device=torch.device(DEVICE), logger=Logger())
        g = torch.Generator().manual_seed(seed + batch)
        crops = torch.randint(0, 256, (batch, 128, 128, 3), generator=g,
                              dtype=torch.uint8).to(DEVICE)
        flips = torch.randint(0, 2, (batch, 2), generator=g).bool().to(DEVICE)
        row = {}
        for name, step in (
            ("pretrain", lambda: trainer.pretrain_step(crops, flips)),
            ("gan", lambda: trainer.gan_step(crops, flips, 1e-4, 1e-4)),
        ):
            step()
            torch.cuda.synchronize()
            times = []
            for _ in range(SPEED_STEPS):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(times)
            row[name] = {"step_ms": ms, "crops_per_s": batch / ms * 1e3,
                         "step_ms_all": times}
        torch.cuda.reset_peak_memory_stats()
        trainer.gan_step(crops, flips, 1e-4, 1e-4)
        row["gan_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if batch == SPEED_BATCHES[-1]:
            prof = profile_device_time(
                lambda: trainer.gan_step(crops, flips, 1e-4, 1e-4), 1)
        rows[batch] = row
        del trainer
    say("train_speed", dtype="bfloat16", rrdb=NUM_RRDB, crop=128,
        **{f"batch{b}": r for b, r in rows.items()})
    say("train_profile", batch=SPEED_BATCHES[-1], step="gan", **prof)
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--only", type=str, default="",
        help="Comma-separated phases to run after probe and build (for "
             "kernel work; prints no kernels or final line): rdb_fwd, "
             "rdb_bwd, train_grad.")
    args = parser.parse_args()
    phase_probe()
    # f32 references in full f32: cuDNN convolutions default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    if args.only:
        phases = {"rdb_fwd": phase_rdb, "rdb_bwd": phase_rdb_bwd,
                  "train_grad": phase_train_grad, "train": phase_train,
                  "train_speed": phase_train_speed}
        for name in args.only.split(","):
            phases[name](args.seed)
        return
    rows = phase_rdb(args.seed)
    bwd_rows = phase_rdb_bwd(args.seed)
    phase_train_grad(args.seed)
    gen = phase_generator(args.seed, rows["bfloat16"]["ms"])
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    ckpt = os.path.join(workdir, "esrgan-gan-best.pth")
    save_checkpoint(ckpt, 1, "gan", gen.state_dict())
    serve_launches = phase_serve(gen, ckpt, args.seed)
    phase_test(ckpt, args.seed)
    del gen
    train = phase_train(args.seed)
    phase_train_speed(args.seed)
    # launches: the main paths' counts (serve, then train), each read
    # with the counters set to 0 just before the path
    fwd, bwd = rows["bfloat16"], bwd_rows["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "rdb_fwd",
        "route": "cuda",
        "source": "torchsr_tpu_torch/ops/csrc/rdb_fwd.cu",
        "replaces": "torchsr_tpu/ops/pallas/rdb.py:142",
        "launches": serve_launches + train["rdb_fwd_launches"],
        "launches_by_path": {"serve": serve_launches,
                             "train": train["rdb_fwd_launches"]},
        "max_abs_err": fwd["max_abs_err"],
        "ms": fwd["ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"],
        "bound_by": fwd["bound_by"],
        "library_ms": None,
        "dtype": "bfloat16",
        "shape": list(SERVE_RDB_SHAPE),
    }, {
        "name": "rdb_bwd",
        "route": "cuda",
        "source": "torchsr_tpu_torch/ops/csrc/rdb_bwd.cu",
        "replaces": "torchsr_tpu/ops/pallas/rdb.py:495",
        "launches": train["rdb_bwd_launches"],
        "launches_by_path": {"serve": 0,
                             "train": train["rdb_bwd_launches"]},
        "max_abs_err": bwd["max_abs_err"],
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": None,
        "dtype": "bfloat16",
        "shape": list(TRAIN_RDB_SHAPE),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
