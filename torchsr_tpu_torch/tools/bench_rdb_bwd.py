"""Time the RDB backward kernels (B2, B8) and a GAN step on one CUDA card.

    python torchsr_tpu_torch/tools/bench_rdb_bwd.py [--root TREE]
        [--gan-profile] [--seed N]

``--root`` names the checkout whose ``torchsr_tpu_torch`` is imported (by
default the one holding this file), so that two trees (a parent and its
change, say) are timed by the same script in one process each, in turns
on one card.  The script builds that tree's kernels into its own
``build/kernels/``.  At the training shape (64, 32, 32, 64), bf16 and
f32, it prints for ``rdb_bwd_cuda`` (B2) and ``rdb_bwd_ext_cuda`` (B8):
the median time of a call over 30 calls (CUDA events, 3 warm-ups), and
the device time of each kernel over 10 calls under ``torch.profiler``,
per call, with the kernels a call launches.  With ``--gan-profile`` it
also profiles one GAN step of the full-width trainer at batch 64 (the
RDB backward's device time, the kernels per step, the device's busy
share of the step's span).  One JSON line on stdout, the card's name and
power limit in it.  It needs a CUDA card and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPE = (64, 32, 32, 64)  # the training shape: batch 64 of 32 x 32 LR
SCALE = 0.2
GAN_BATCH = 64


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


def _profile(torch, fn, calls: int, key=_short) -> dict:
    """Device ms per call by ``key`` of the kernel name, kernels per call
    and the busy share of the span from the first kernel to the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
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


def bench_kernels(torch, rdb_ops, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    ks = [(torch.randn((3, 3, ci, co), generator=gen) * 0.05).cuda()
          for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)]
    bs = [(torch.randn((co,), generator=gen) * 0.1).cuda()
          for co in rdb_ops.COUT]
    x = (torch.randn(SHAPE, generator=gen) * 0.5).cuda()
    g = (torch.randn(SHAPE, generator=gen) * 0.1).cuda()
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


def _rdb_bwd_class(name: str) -> bool:
    return any(k in name for k in (
        "rdb_bwd_", "wgrad_bf16", "wgrad_f32", "dgrad_bf16", "dgrad_f32",
        "reduce_partials", "::prep<"))


def gan_profile(torch, root: str, seed: int) -> dict:
    """One GAN step at batch 64 (bf16, 23 RRDBs, crop 128) under the
    profiler, after two unprofiled steps, on 40 seeded 160 x 160 PNGs."""
    from argparse import Namespace

    import numpy as np
    from PIL import Image

    from torchsr_tpu_torch.data.loader import initialize_datasets
    from torchsr_tpu_torch.train.trainer import ESRGANTrainer
    from torchsr_tpu_torch.utils.logging import Logger

    ds = os.path.join(root, "build", "bench_rdb_bwd", "ds")
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
    prof = _profile(torch, step, 1,
                    key=lambda n: "rdb_bwd" if _rdb_bwd_class(n) else "other")
    return {"step_device_ms": prof["device_ms"],
            "rdb_bwd_device_ms": prof["by_kernel"].get("rdb_bwd", 0.0),
            "kernels_per_step": prof["kernels_per_call"],
            "busy_share_of_span": prof["busy_share_of_span"]}


def main(argv=None) -> None:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=here)
    parser.add_argument("--gan-profile", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.environ["WANDB_MODE"] = "disabled"  # the trainer's logger: no sink
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_rdb_bwd needs a CUDA card")
    from torchsr_tpu_torch.ops import rdb as rdb_ops

    for name in ("EXT_KERNEL", "ILV_KERNEL", "BWD_XLA"):
        setattr(rdb_ops, name, False)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    row = {"root": root, "card": card, "shape": list(SHAPE),
           **bench_kernels(torch, rdb_ops, args.seed)}
    if args.gan_profile:
        row["gan_step_batch64"] = gan_profile(torch, root, args.seed)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
