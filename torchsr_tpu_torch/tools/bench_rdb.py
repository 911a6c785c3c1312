"""Time the RDB kernels (B1, B7, B6; with --bwd B2, B8) on one CUDA card.

    python torchsr_tpu_torch/tools/bench_rdb.py [--root TREE] [--bwd]
        [--gan-profile] [--serve-profile] [--serve-ilv-profile]
        [--pair-synth] [--seed N]

The counterpart of the JAX package's ``tools/bench_rdb.py``.  ``--root``
names the checkout whose ``torchsr_tpu_torch`` is imported (by default
the one holding this file), so that two trees (a parent and its change,
say) are timed by the same script in one process each, in turns on one
card.  The script builds that tree's kernels into its own
``build/kernels/``.

It prints, for the block forward ``rdb_fwd_cuda`` (B1) and
``rdb_fwd_ext_cuda`` (B7) at the serving shape (16, 64, 64, 64) and the
training shape (64, 32, 32, 64), and ``rdb_fwd_ilv_cuda`` (B6) at the
serving shape and the ragged (3, 37, 45, 64), bf16 and f32: the median
time of a call
over 30 calls (CUDA events, 3 warm-ups), and the device time of each
kernel a call launches, by its position in the call, over 10 calls under
``torch.profiler``, with the kernels a call launches.  The weights are
contiguous in the working dtype; ``b1_bf16_f32views`` also times B1 in
bf16 with f32 permuted views of OIHW weights, as the trainer hands them.
``--bwd`` adds the backward, ``rdb_bwd_cuda`` (B2) and
``rdb_bwd_ext_cuda`` (B8), at the training shape the same way.
``--gan-profile`` profiles one GAN step of the full-width trainer at
batch 64 and ``--serve-profile`` three (16, 64, 64, 3) tile batches of
the 23-RRDB generator in bf16: the RDB forward's (and backward's)
device time, the kernels per step or batch, the device's busy share of
the span; ``--serve-ilv-profile`` the same tile batches with
``TORCHSR_RDB_ILV``'s variant (B6) selected.  ``--pair-synth`` times
the pair synthesis kernel (B3, ``synthesize_pair_cuda``) at the bench
tool's shape (64, 96, 96, 3), a call (CUDA events) and its device time,
and runs ``tools/bench_preprocess.py``'s measurement (median and p90 µs
a synthesized batch) on that tree.  One JSON line on stdout, the card's
name and power limit in it.  It needs a CUDA card and the CUDA toolkit.
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
SYNTH_SHAPE = (64, 96, 96, 3)  # tools/bench_preprocess.py's defaults
SCALE = 0.2
GAN_BATCH = 64
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
                             ("ragged", RAGGED_SHAPE)):
            x = (torch.randn(shape, generator=gen) * 0.5).cuda()
            for dtype in (torch.bfloat16, torch.float32):
                xd = x.to(dtype)
                kd = [k.to(dtype) for k in ks]
                name = str(dtype).removeprefix("torch.")
                out[f"{where}_b6_{name}"] = _timed(
                    torch, lambda: rdb_ops.rdb_fwd_ilv_cuda(
                        xd, kd, bs, scale_ratio=SCALE))
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


def bench_backward(torch, rdb_ops, seed: int) -> dict:
    gen, ks, bs = _weights(torch, rdb_ops, seed)
    x = (torch.randn(TRAIN_SHAPE, generator=gen) * 0.5).cuda()
    g = (torch.randn(TRAIN_SHAPE, generator=gen) * 0.1).cuda()
    out = {}
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            xd, gd = x.to(dtype), g.to(dtype)
            kd = [k.to(dtype) for k in ks]
            _, feat = rdb_ops.rdb_fwd_cuda(xd, kd, bs, scale_ratio=SCALE)
            _, featp = rdb_ops.rdb_fwd_ext_cuda(xd, kd, bs, scale_ratio=SCALE)
            calls = {
                "b2": lambda: rdb_ops.rdb_bwd_cuda(gd, feat, kd,
                                                   scale_ratio=SCALE),
                "b8": lambda: rdb_ops.rdb_bwd_ext_cuda(gd, featp, kd,
                                                       scale_ratio=SCALE),
            }
            name = str(dtype).removeprefix("torch.")
            for k, fn in calls.items():
                out[f"{k}_{name}"] = {"ms": _median_ms(torch, fn),
                                      **_profile(torch, fn, 10)}
    return out


def _rdb_class(name: str) -> str:
    """``rdb_fwd``, ``rdb_bwd`` or ``other``: the RDB forward's kernels
    (an older tree's direct ``conv3x3_*``, the Hopper ``rdb_fwd_sm90``
    ones, B6's) and the backward's (both generations)."""
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


def gan_profile(torch, root: str, seed: int) -> dict:
    """One GAN step at batch 64 (bf16, 23 RRDBs, crop 128) under the
    profiler, after two unprofiled steps, on 40 seeded 160 x 160 PNGs."""
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
    args = Namespace(batch_size=GAN_BATCH, epochs=1, pretrain_epochs=1,
                     seed=seed, skip_image_save=True, disable_amp=False,
                     metrics_file=None)
    trainer = ESRGANTrainer(
        args, *initialize_datasets(ds, GAN_BATCH, 128, seed=seed),
        device=torch.device("cuda"), logger=Logger())
    gen = torch.Generator().manual_seed(seed)
    crops = torch.randint(0, 256, (GAN_BATCH, 128, 128, 3), generator=gen,
                          dtype=torch.uint8).cuda()
    flips = torch.randint(0, 2, (GAN_BATCH, 2), generator=gen).bool().cuda()

    def step():
        trainer.gan_step(crops, flips, 1e-4, 1e-4)

    for _ in range(2):
        step()
    return _summary(_profile(torch, step, 1, key=_rdb_class), "step")


def serve_profile(torch, seed: int) -> dict:
    """Three tile batches (16, 64, 64, 3) of the 23-RRDB generator (seeded
    random weights) in bf16 under ``torch.inference_mode``, after two
    unprofiled ones, under the profiler: per batch.  The RDB variant is
    the one ``ops.rdb``'s knobs select."""
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator

    gen = ESRGANGenerator(
        num_rrdb_blocks=NUM_RRDB,
        generator=torch.Generator().manual_seed(seed)).cuda()
    gen.requires_grad_(False)
    gen.compute_dtype = torch.bfloat16
    x = torch.rand(TILE_BATCH, generator=torch.Generator().manual_seed(
        seed + 1)).cuda()
    with torch.inference_mode():
        row = {"ms": _median_ms(torch, lambda: gen(x), reps=5, warmup=2)}
        row.update(_summary(_profile(torch, lambda: gen(x), 3,
                                     key=_rdb_class), "batch"))
    return row


def main(argv=None) -> None:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=here)
    parser.add_argument("--bwd", action="store_true")
    parser.add_argument("--gan-profile", action="store_true")
    parser.add_argument("--serve-profile", action="store_true")
    parser.add_argument("--serve-ilv-profile", action="store_true")
    parser.add_argument("--pair-synth", action="store_true")
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
    if args.gan_profile:
        row["gan_step_batch64"] = gan_profile(torch, root, args.seed)
    if args.pair_synth:
        row["pair_synth"] = bench_pair_synth(torch, args.seed)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
