"""Time the plain pair synthesis against the fused kernel.

The port of the JAX package's ``tools/bench_preprocess.py``: the same
seeded uint8 crops and flips, each path timed over ``--steps`` calls
with a synchronized host clock after one warm-up call.  ``plain`` is
``data.preprocess.synthesize_pair`` (the XLA path's counterpart),
``kernel`` is ``ops.preprocess.synthesize_pair_cuda`` (the Pallas
kernel's).  One JSON line per path.

Usage: python -m torchsr_tpu_torch.tools.bench_preprocess [--batch 64]
       [--crop 96] [--steps 50] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from torchsr_tpu_torch.data.preprocess import synthesize_pair
from torchsr_tpu_torch.ops.preprocess import synthesize_pair_cuda


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--crop", type=int, default=96)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu, where both paths "
                             "run the plain version")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; pass --device "
                           "cpu to run on the CPU")

    rng = np.random.default_rng(0)
    crops = torch.from_numpy(rng.integers(
        0, 256, (args.batch, args.crop, args.crop, 3), dtype=np.uint8
    )).to(device)
    flips = torch.from_numpy(rng.random((args.batch, 2)) < 0.5).to(device)

    rows = {}
    for name, fn in (("plain", synthesize_pair),
                     ("kernel", synthesize_pair_cuda)):
        fn(crops, flips)
        _sync(device)
        times = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            fn(crops, flips)
            _sync(device)
            times.append(time.perf_counter() - t0)
        rows[name] = row = {
            "path": name, "device": str(device),
            "shape": [args.batch, args.crop, args.crop, 3],
            "steps": args.steps,
            "median_us": float(np.median(times) * 1e6),
            "p90_us": float(np.percentile(times, 90) * 1e6),
        }
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
