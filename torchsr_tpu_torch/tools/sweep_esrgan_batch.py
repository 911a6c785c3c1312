"""ESRGAN GAN-step batch sweep on one CUDA card.

The port of the JAX package's ``tools/sweep_esrgan_batch.py``: it drives
``tools/bench.py``'s ``bench_esrgan_gan`` (the same protocol: chained
multi-step calls, two measured phases, the second kept) at each batch
size, with a throwaway run first and a second pass in the reverse order,
since the first variant measured in a process can read slow even after
its own warm-up.

    python -m torchsr_tpu_torch.tools.sweep_esrgan_batch [--batches 32,48,64]
"""

from __future__ import annotations

import argparse
import gc

import torch

from torchsr_tpu_torch.tools import bench


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batches", default="32,48,64")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    batches = [int(b) for b in args.batches.split(",")]
    order = [batches[0]] + batches + list(reversed(batches))
    print(f"# sweep order (first is throwaway): {order}", flush=True)
    rows = []
    for i, b in enumerate(order):
        tag = ("throwaway" if i == 0
               else f"pass{1 if i <= len(batches) else 2}")
        print(f"--- batch {b} ({tag}) ---", flush=True)
        rows.append((b, tag, bench.bench_esrgan_gan(b, device=args.device)))
        gc.collect()
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()  # the last trainer's graphs' pools
    return rows


if __name__ == "__main__":
    main()
