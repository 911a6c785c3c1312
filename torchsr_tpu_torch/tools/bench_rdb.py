"""Time the RDB kernels (B1, B7, B6; with --bwd B2, B8) on one CUDA card.

    python torchsr_tpu_torch/tools/bench_rdb.py [--root TREE] [--bwd]
        [--gan-profile] [--gan-profile-f32] [--serve-profile]
        [--serve-ilv-profile] [--serve-f32-profile]
        [--serve-ilv-f32-profile] [--eval-f32] [--pair-synth] [--hashes]
        [--seed N]

The counterpart of the JAX package's ``tools/bench_rdb.py``.  ``--root``
names the checkout whose ``torchsr_tpu_torch`` is imported (by default
the one holding this file), so that two trees (a parent and its change,
say) are timed by the same script in one process each, in turns on one
card.  The script builds that tree's kernels into its own
``build/kernels/``.

It prints, for the block forward ``rdb_fwd_cuda`` (B1) and
``rdb_fwd_ext_cuda`` (B7) at the serving shape (16, 64, 64, 64) and the
training shape (64, 32, 32, 64), and ``rdb_fwd_ilv_cuda`` (B6) at the
serving shape, the ragged (3, 37, 45, 64) and ``eval``'s whole 44 x 44
LR image (1, 44, 44, 64), bf16 and f32, and B1 at
that ragged shape and at ``eval``'s whole 44 x 44 LR image (1, 44, 44,
64; the quality corpus's 176 x 176 eval images): the median time of a
call
over 30 calls (CUDA events, 3 warm-ups), and the device time of each
kernel a call launches, by its position in the call, over 10 calls under
``torch.profiler``, with the kernels a call launches.  The weights are
contiguous in the working dtype; ``b1_bf16_f32views`` also times B1 in
bf16 with f32 permuted views of OIHW weights, as the trainer hands them.
The f32 block's plain version (``rdb_reference``: five ``F.conv2d``,
TF32 off) is timed at the serving and training shapes the same way.
``--bwd`` adds the backward, ``rdb_bwd_cuda`` (B2) and
``rdb_bwd_ext_cuda`` (B8), bf16 and f32, at the training shape and at
the LR batches of ``train --scale 2`` and ``--scale 8`` (16, 64, 64, 64)
and (16, 16, 16, 64) the same way.
``--gan-profile`` profiles one GAN step of the full-width trainer at
batch 64 (bf16), ``--gan-profile-f32`` one at batch 32 with
``disable_amp`` and TF32 off (crop 128, the f32 quality runs' recipe),
and ``--serve-profile`` three (16, 64, 64, 3) tile batches of
the 23-RRDB generator in bf16: the RDB forward's (and backward's)
device time, the kernels per step or batch, the device's busy share of
the span; ``--serve-ilv-profile`` the same tile batches with
``TORCHSR_RDB_ILV``'s variant (B6) selected; ``--serve-f32-profile``
the same tile batches in f32 (TF32 off), the path of ``eval`` and of the
trainer's validation and renders, and ``--serve-ilv-f32-profile`` those
f32 tile batches with B6 selected.  ``--eval-f32`` times ``eval``'s
``run_eval`` (f32, whole images, TF32 off, as the subcommand runs it)
over 24 seeded 176 x 176 PNGs with a seeded 23-RRDB checkpoint: the
wall time of the second of two runs.  ``--pair-synth`` times
the pair synthesis kernel (B3, ``synthesize_pair_cuda``) at the bench
tool's shape (64, 96, 96, 3), a call (CUDA events) and its device time,
and runs ``tools/bench_preprocess.py``'s measurement (median and p90 µs
a synthesized batch) on that tree.  ``--hashes`` prints digests of B1's,
B7's and B6's outputs and feature buffers at nine shapes in both dtypes, and
of B2's and B8's bf16 outputs (dx, dW, db, DY) at five, so that two
trees can be shown to compute the same bits.  One JSON line
on stdout, the card's name and power limit in it.  It needs a CUDA card
and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SERVE_SHAPE = (16, 64, 64, 64)  # a serving tile batch of 64 x 64 LR tiles
TRAIN_SHAPE = (64, 32, 32, 64)  # batch 64 of 32 x 32 LR crops
RAGGED_SHAPE = (3, 37, 45, 64)  # a whole image's blocks, as `test` gives
EVAL_SHAPE = (1, 44, 44, 64)  # `eval` on a 176 x 176 image: one at a time
EVAL_IMAGES = 24  # the quality corpus's eval set: 24 images of 176 x 176
EVAL_HW = (176, 176)
SYNTH_SHAPE = (64, 96, 96, 3)  # tools/bench_preprocess.py's defaults
SCALE = 0.2
GAN_BATCH = 64
GAN_F32_BATCH = 32  # the f32 quality runs' batch (tools/quality_run.py)
TILE_BATCH = (16, 64, 64, 3)
NUM_RRDB = 23


def _median_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _short(name: str) -> str:
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:60]


PROFILE_WINDOWS = 3  # a window with no device event is taken again


def _spans(torch, fn, calls: int) -> list:
    """(start, end, name) of every device kernel of ``calls`` calls of
    ``fn`` under the profiler, in order.  The profiler now and then
    returns a window with no device event: such a window is run again,
    ``PROFILE_WINDOWS`` windows at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # the first call's allocations and caches outside the window
    torch.cuda.synchronize()
    spans: list = []
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            break
    return spans


def _by_launch(torch, fn, calls: int = 10) -> dict:
    """Device ms per call, kernels per call, and each launch of a call by
    its position (name and device ms, averaged over the calls)."""
    spans = _spans(torch, fn, calls)
    per = len(spans) // calls
    by = [[_short(spans[i][2]), sum(
        spans[c * per + i][1] - spans[c * per + i][0]
        for c in range(calls)) / calls / 1e3] for i in range(per)]
    return {"device_ms": sum(ms for _, ms in by), "kernels_per_call": per,
            "whole_calls": len(spans) == per * calls, "by_launch": by}


def _profile(torch, fn, calls: int, key=_short) -> dict:
    """Device ms per call by ``key`` of the kernel name, kernels per call
    and the busy share of the span from the first kernel to the last."""
    spans = _spans(torch, fn, calls)
    by: dict = {}
    busy, cur = 0.0, None
    for start, end, name in spans:
        k = key(name)
        by[k] = by.get(k, 0.0) + (end - start) / 1e3 / calls
        if cur is None or start > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [start, end]
        else:
            cur[1] = max(cur[1], end)
    if cur is not None:
        busy += cur[1] - cur[0]
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    return {"device_ms": sum(by.values()),
            "by_kernel": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "kernels_per_call": len(spans) / calls,
            "busy_share_of_span": busy / span if span else None}


def _weights(torch, rdb_ops, seed: int):
    gen = torch.Generator().manual_seed(seed)
    ks = [(torch.randn((3, 3, ci, co), generator=gen) * 0.05).cuda()
          for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)]
    bs = [(torch.randn((co,), generator=gen) * 0.1).cuda()
          for co in rdb_ops.COUT]
    return gen, ks, bs


def _timed(torch, fn) -> dict:
    return {"ms": _median_ms(torch, fn), **_by_launch(torch, fn)}


def bench_forward(torch, rdb_ops, seed: int) -> dict:
    gen, ks, bs = _weights(torch, rdb_ops, seed)
    # the trainer's case: HWIO views of f32 OIHW parameters
    views = [k.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
             for k in ks]
    out = {}
    with torch.inference_mode():
        for where, shape in (("serve", SERVE_SHAPE), ("train", TRAIN_SHAPE)):
            x = (torch.randn(shape, generator=gen) * 0.5).cuda()
            for dtype in (torch.bfloat16, torch.float32):
                xd = x.to(dtype)
                kd = [k.to(dtype) for k in ks]
                name = str(dtype).removeprefix("torch.")
                out[f"{where}_b1_{name}"] = _timed(
                    torch, lambda: rdb_ops.rdb_fwd_cuda(xd, kd, bs,
                                                        scale_ratio=SCALE))
                out[f"{where}_b7_{name}"] = _timed(
                    torch, lambda: rdb_ops.rdb_fwd_ext_cuda(
                        xd, kd, bs, scale_ratio=SCALE))
            xb = x.to(torch.bfloat16)
            out[f"{where}_b1_bf16_f32views"] = _timed(
                torch, lambda: rdb_ops.rdb_fwd_cuda(xb, views, bs,
                                                    scale_ratio=SCALE))
        for where, shape in (("serve", SERVE_SHAPE),
                             ("ragged", RAGGED_SHAPE), ("eval", EVAL_SHAPE)):
            x = (torch.randn(shape, generator=gen) * 0.5).cuda()
            for dtype in (torch.bfloat16, torch.float32):
                xd = x.to(dtype)
                kd = [k.to(dtype) for k in ks]
                name = str(dtype).removeprefix("torch.")
                out[f"{where}_b6_{name}"] = _timed(
                    torch, lambda: rdb_ops.rdb_fwd_ilv_cuda(
                        xd, kd, bs, scale_ratio=SCALE))
        for where, shape in (("ragged", RAGGED_SHAPE), ("eval", EVAL_SHAPE)):
            x = (torch.randn(shape, generator=gen) * 0.5).cuda()
            out[f"{where}_b1_float32"] = _timed(
                torch, lambda: rdb_ops.rdb_fwd_cuda(x, ks, bs,
                                                    scale_ratio=SCALE))
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            for where, shape in (("serve", SERVE_SHAPE),
                                 ("train", TRAIN_SHAPE)):
                x = (torch.randn(shape, generator=gen) * 0.5).cuda()
                out[f"{where}_plain_float32"] = _timed(
                    torch, lambda: rdb_ops.rdb_reference(
                        x, ks, bs, scale_ratio=SCALE))
        finally:
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
    return out


# The shapes ``--hashes`` runs B1 at (B7 where the width is a multiple of
# 16): chip_smoke.py's rdb_fwd shapes, a one-pixel-wide and a 65-wide one.
HASH_SHAPES = {"serve": SERVE_SHAPE, "ragged": RAGGED_SHAPE,
               "wide": (2, 6, 140, 64), "ext_wide": (2, 6, 144, 64),
               "train": TRAIN_SHAPE, "eval": EVAL_SHAPE,
               "ext_ragged": (3, 37, 48, 64), "w1": (2, 5, 1, 64),
               "w65": (2, 9, 65, 64)}


def forward_hashes(torch, rdb_ops, seed: int) -> dict:
    """The first 16 hex digits of the SHA-256 of B1's, B7's and B6's
    output and feature buffer (B7: its data rows; B6: its interleaved
    buffer) at each of ``HASH_SHAPES``, in bf16 (also with f32 views of
    the weights) and f32, on seeded inputs: two trees whose kernels
    compute the same bits print the same hashes."""
    import hashlib

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu()
                              .numpy().tobytes()).hexdigest()[:16]

    gen, ks, bs = _weights(torch, rdb_ops, seed)
    views = [k.permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
             for k in ks]
    out = {}
    with torch.inference_mode():
        for where, shape in HASH_SHAPES.items():
            x = (torch.randn(shape, generator=gen) * 0.5).cuda()
            for name, dtype, kd in (
                    ("bfloat16", torch.bfloat16,
                     [k.to(torch.bfloat16) for k in ks]),
                    ("bf16_f32views", torch.bfloat16, views),
                    ("float32", torch.float32, ks)):
                xd = x.to(dtype)
                y, feat = rdb_ops.rdb_fwd_cuda(xd, kd, bs, scale_ratio=SCALE)
                out[f"{where}_b1_{name}"] = [digest(y), digest(feat)]
                if shape[2] % 16 == 0:
                    y, feat = rdb_ops.rdb_fwd_ext_cuda(xd, kd, bs,
                                                       scale_ratio=SCALE)
                    out[f"{where}_b7_{name}"] = [digest(y),
                                                 digest(feat[:, 1:-1])]
                y, buf = rdb_ops.rdb_fwd_ilv_cuda(xd, kd, bs,
                                                  scale_ratio=SCALE)
                out[f"{where}_b6_{name}"] = [digest(y), digest(buf)]
    return out


def bench_pair_synth(torch, seed: int) -> dict:
    """B3 at ``SYNTH_SHAPE``: a call's median time (CUDA events) and its
    device time under the profiler, then ``bench_preprocess``'s own
    measurement (its JSON lines go to stdout as well)."""
    from torchsr_tpu_torch.ops.preprocess import synthesize_pair_cuda
    from torchsr_tpu_torch.tools import bench_preprocess

    gen = torch.Generator().manual_seed(seed)
    crops = torch.randint(0, 256, SYNTH_SHAPE, generator=gen,
                          dtype=torch.uint8).cuda()
    flips = (torch.rand((SYNTH_SHAPE[0], 2), generator=gen) < 0.5).cuda()
    row = _timed(torch, lambda: synthesize_pair_cuda(crops, flips))
    row["bench_preprocess"] = bench_preprocess.main([])
    return row


# The backward's shapes: the training batch, and the LR batches of
# ``train --scale 2`` and ``--scale 8`` at crop 128 and batch 16.
BWD_SHAPES = {"train": TRAIN_SHAPE, "scale2": (16, 64, 64, 64),
              "scale8": (16, 16, 16, 64)}


def bench_backward(torch, rdb_ops, seed: int) -> dict:
    """B2 and B8, bf16 and f32, at ``BWD_SHAPES``: a call's median time
    and its device time by launch (``_timed``)."""
    gen, ks, bs = _weights(torch, rdb_ops, seed)
    out = {}
    with torch.no_grad():
        for where, shape in BWD_SHAPES.items():
            x = (torch.randn(shape, generator=gen) * 0.5).cuda()
            g = (torch.randn(shape, generator=gen) * 0.1).cuda()
            for dtype in (torch.bfloat16, torch.float32):
                xd, gd = x.to(dtype), g.to(dtype)
                kd = [k.to(dtype) for k in ks]
                _, feat = rdb_ops.rdb_fwd_cuda(xd, kd, bs, scale_ratio=SCALE)
                _, featp = rdb_ops.rdb_fwd_ext_cuda(xd, kd, bs,
                                                    scale_ratio=SCALE)
                name = str(dtype).removeprefix("torch.")
                out[f"{where}_b2_{name}"] = _timed(
                    torch, lambda: rdb_ops.rdb_bwd_cuda(gd, feat, kd,
                                                        scale_ratio=SCALE))
                out[f"{where}_b8_{name}"] = _timed(
                    torch, lambda: rdb_ops.rdb_bwd_ext_cuda(
                        gd, featp, kd, scale_ratio=SCALE))
    return out


# The shapes ``--hashes`` runs the bf16 backward at (B8 where the width
# is a multiple of 16).
BWD_HASH_SHAPES = {"train": TRAIN_SHAPE, "ragged": RAGGED_SHAPE,
                   "scale8": (16, 16, 16, 64), "ext_ragged": (3, 37, 48, 64),
                   "w65": (2, 9, 65, 64)}


def backward_hashes(torch, rdb_ops, seed: int) -> dict:
    """As ``forward_hashes`` for the bf16 backward: digests of B2's (and
    B8's) dx, dW, db and DY (B8: its data rows) at ``BWD_HASH_SHAPES``,
    on the feature buffer B1 (B7) filled from seeded inputs."""
    import hashlib

    def digest(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        return h.hexdigest()[:16]

    gen, ks, bs = _weights(torch, rdb_ops, seed + 1)
    kd = [k.to(torch.bfloat16) for k in ks]
    out = {}
    with torch.no_grad():
        for where, shape in BWD_HASH_SHAPES.items():
            x = (torch.randn(shape, generator=gen) * 0.5).cuda().bfloat16()
            g = (torch.randn(shape, generator=gen) * 0.1).cuda().bfloat16()
            _, feat = rdb_ops.rdb_fwd_cuda(x, kd, bs, scale_ratio=SCALE)
            dx, dws, dbs, dy = rdb_ops.rdb_bwd_cuda(g, feat, kd,
                                                    scale_ratio=SCALE)
            out[f"{where}_b2"] = [digest([dx]), digest(dws), digest(dbs),
                                  digest([dy])]
            if shape[2] % 16 == 0:
                _, featp = rdb_ops.rdb_fwd_ext_cuda(x, kd, bs,
                                                    scale_ratio=SCALE)
                dx, dws, dbs, dy = rdb_ops.rdb_bwd_ext_cuda(
                    g, featp, kd, scale_ratio=SCALE)
                out[f"{where}_b8"] = [digest([dx]), digest(dws),
                                      digest(dbs), digest([dy[:, 1:-1]])]
    return out


def _rdb_class(name: str) -> str:
    """``rdb_fwd``, ``rdb_bwd`` or ``other``: the RDB forward's kernels
    (an older tree's direct ``conv3x3_*``, the Hopper ``rdb_fwd_sm90``
    ones, B6's) and the backward's (every generation: an older tree's
    FFMA f32 kernels too)."""
    if any(k in name for k in ("conv3x3_", "rdb_fwd_", "ilv_conv_",
                               "grow_x")):
        return "rdb_fwd"
    if any(k in name for k in (
            "rdb_bwd_", "wgrad_bf16", "wgrad_f32", "dgrad_bf16", "dgrad_f32",
            "reduce_partials", "::prep<")):
        return "rdb_bwd"
    return "other"


def _summary(prof: dict, what: str) -> dict:
    return {f"{what}_device_ms": prof["device_ms"],
            "rdb_fwd_device_ms": prof["by_kernel"].get("rdb_fwd", 0.0),
            "rdb_bwd_device_ms": prof["by_kernel"].get("rdb_bwd", 0.0),
            f"kernels_per_{what}": prof["kernels_per_call"],
            "busy_share_of_span": prof["busy_share_of_span"]}


def gan_profile(torch, root: str, seed: int, batch: int = GAN_BATCH,
                f32: bool = False) -> dict:
    """One GAN step at ``batch`` (bf16, or with ``f32`` in f32: the
    trainer's ``disable_amp``, TF32 off; 23 RRDBs, crop 128) under the
    profiler, after two unprofiled steps, on 40 seeded 160 x 160 PNGs;
    the step's median host time over 5 steps beside it."""
    from argparse import Namespace

    import numpy as np
    from PIL import Image

    from torchsr_tpu_torch.data.loader import initialize_datasets
    from torchsr_tpu_torch.train.trainer import ESRGANTrainer
    from torchsr_tpu_torch.utils.logging import Logger

    ds = os.path.join(root, "build", "bench_rdb", "ds")
    os.makedirs(ds, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(40):
        Image.fromarray(rng.integers(0, 256, (160, 160, 3), np.uint8)).save(
            os.path.join(ds, f"img{i:03d}.png"))
    args = Namespace(batch_size=batch, epochs=1, pretrain_epochs=1,
                     seed=seed, skip_image_save=True, disable_amp=f32,
                     metrics_file=None)
    trainer = ESRGANTrainer(
        args, *initialize_datasets(ds, batch, 128, seed=seed),
        device=torch.device("cuda"), logger=Logger())
    gen = torch.Generator().manual_seed(seed)
    crops = torch.randint(0, 256, (batch, 128, 128, 3), generator=gen,
                          dtype=torch.uint8).cuda()
    flips = torch.randint(0, 2, (batch, 2), generator=gen).bool().cuda()

    def step():
        trainer.gan_step(crops, flips, 1e-4, 1e-4)

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    if f32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for _ in range(2):
            step()
        row = _summary(_profile(torch, step, 1, key=_rdb_class), "step")
        row["step_ms"] = _median_ms(torch, step, reps=5, warmup=1)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    row["rdb_bwd_share"] = row["rdb_bwd_device_ms"] / row["step_device_ms"]
    return {"batch": batch, "f32": f32, **row}


def serve_profile(torch, seed: int, dtype=None) -> dict:
    """Three tile batches (16, 64, 64, 3) of the 23-RRDB generator (seeded
    random weights) in ``dtype`` (bf16 by default) under
    ``torch.inference_mode``, after two unprofiled ones, under the
    profiler: per batch.  The RDB variant is the one ``ops.rdb``'s knobs
    select."""
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator

    gen = ESRGANGenerator(
        num_rrdb_blocks=NUM_RRDB,
        generator=torch.Generator().manual_seed(seed)).cuda()
    gen.requires_grad_(False)
    gen.compute_dtype = dtype or torch.bfloat16
    x = torch.rand(TILE_BATCH, generator=torch.Generator().manual_seed(
        seed + 1)).cuda()
    with torch.inference_mode():
        row = {"ms": _median_ms(torch, lambda: gen(x), reps=5, warmup=2)}
        row.update(_summary(_profile(torch, lambda: gen(x), 3,
                                     key=_rdb_class), "batch"))
    return row


def eval_f32(torch, root: str, seed: int) -> dict:
    """``run_eval`` in f32 on whole images (``eval``'s default; TF32 off)
    over ``EVAL_IMAGES`` seeded PNGs of ``EVAL_HW`` with a seeded 23-RRDB
    checkpoint: the wall time of the second of two runs (the first
    builds and warms up), and the RDB forward launches it made."""
    import contextlib
    import io
    import time
    from argparse import Namespace

    import numpy as np
    from PIL import Image

    from torchsr_tpu_torch.infer.evaluate import run_eval
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
    from torchsr_tpu_torch.ops import rdb as rdb_ops
    from torchsr_tpu_torch.utils.checkpoint import save_checkpoint

    folder = os.path.join(root, "build", "bench_rdb", "eval")
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(EVAL_IMAGES):
        Image.fromarray(rng.integers(0, 256, (*EVAL_HW, 3), np.uint8)).save(
            os.path.join(folder, f"img{i:02d}.png"))
    gen = ESRGANGenerator(num_rrdb_blocks=NUM_RRDB,
                          generator=torch.Generator().manual_seed(seed))
    ckpt = os.path.join(root, "build", "bench_rdb", "eval_gen.pth")
    save_checkpoint(ckpt, 1, "gan", gen.state_dict())
    args = Namespace(image_dir=folder, model="esrgan", checkpoint=ckpt,
                     crop=None, tile=0, tile_overlap=16, tile_batch=8,
                     bf16=False, save_sr=False, report=None, device="cuda")
    walls = []
    for _ in range(2):
        before = rdb_ops.RDB_FWD_F32_LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            report = run_eval(args, ESRGANGenerator)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return {"images": report["images"], "wall_s": walls[-1],
            "first_wall_s": walls[0],
            "rdb_fwd_f32_launches": rdb_ops.RDB_FWD_F32_LAUNCHES - before}


def main(argv=None) -> None:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=here)
    parser.add_argument("--bwd", action="store_true")
    parser.add_argument("--gan-profile", action="store_true")
    parser.add_argument("--gan-profile-f32", action="store_true")
    parser.add_argument("--serve-profile", action="store_true")
    parser.add_argument("--serve-ilv-profile", action="store_true")
    parser.add_argument("--serve-f32-profile", action="store_true")
    parser.add_argument("--serve-ilv-f32-profile", action="store_true")
    parser.add_argument("--eval-f32", action="store_true")
    parser.add_argument("--pair-synth", action="store_true")
    parser.add_argument("--hashes", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.environ["WANDB_MODE"] = "disabled"  # the trainer's logger: no sink
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_rdb needs a CUDA card")
    from torchsr_tpu_torch.ops import rdb as rdb_ops

    for name in ("EXT_KERNEL", "ILV_KERNEL", "BWD_XLA"):
        setattr(rdb_ops, name, False)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    row = {"root": root, "card": card,
           "forward": bench_forward(torch, rdb_ops, args.seed)}
    if args.bwd:
        row["backward"] = bench_backward(torch, rdb_ops, args.seed)
    if args.serve_profile:
        row["serve_tile_batch"] = serve_profile(torch, args.seed)
    if args.serve_ilv_profile:
        rdb_ops.ILV_KERNEL = True
        row["serve_ilv_tile_batch"] = serve_profile(torch, args.seed)
        rdb_ops.ILV_KERNEL = False
    for flag, ilv in ((args.serve_f32_profile, False),
                      (args.serve_ilv_f32_profile, True)):
        if flag:
            cudnn_tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            rdb_ops.ILV_KERNEL = ilv
            row["serve_ilv_f32_tile_batch" if ilv
                else "serve_f32_tile_batch"] = serve_profile(
                    torch, args.seed, torch.float32)
            rdb_ops.ILV_KERNEL = False
            torch.backends.cudnn.allow_tf32 = cudnn_tf32
    if args.eval_f32:
        row["eval_f32"] = eval_f32(torch, root, args.seed)
    if args.gan_profile:
        row["gan_step_batch64"] = gan_profile(torch, root, args.seed)
    if args.gan_profile_f32:
        row["gan_step_f32_batch32"] = gan_profile(
            torch, root, args.seed, GAN_F32_BATCH, f32=True)
    if args.pair_synth:
        row["pair_synth"] = bench_pair_synth(torch, args.seed)
    if args.hashes:
        row["hashes"] = forward_hashes(torch, rdb_ops, args.seed)
        row["bwd_hashes"] = backward_hashes(torch, rdb_ops, args.seed)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
