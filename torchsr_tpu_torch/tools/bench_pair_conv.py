"""Time the 3x3 64 -> 64 conv kernels against the library convolution.

The port of the JAX package's ``tools/bench_pair_conv.py``, with its
protocol: each measurement runs a chain of convolutions (forward, or
forward and backward with every gradient fed back into the next step)
and the cost per conv is the slope between 8 and 24 links, so that the
fixed costs cancel; every timed phase ends in a scalar read back to the
host; a throwaway measured phase runs first; each path is measured twice
and the second kept.  ``reference`` is ``ops.pair_conv.conv_reference``
(one cuDNN convolution, and its autograd backward), ``kernel`` is
``ops.pair_conv.pair_conv`` (csrc/pair_conv.cu).  In f32 the library
convolution runs without TF32 (full f32 products); the kernels take
each f32 product as three TF32 products of the operands' high and low
TF32 parts (3xTF32), which holds the f32 limits that one TF32 product
breaks.  The port runs eagerly: there is no compile step to warm.  One
JSON line per mode.

Usage: python -m torchsr_tpu_torch.tools.bench_pair_conv [--batch 128]
       [--h 24] [--w 24] [--dtype bf16|f32] [--mode fwd|fwdbwd|both]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from torchsr_tpu_torch.ops.pair_conv import conv_reference, pair_conv

REPS_LO, REPS_HI = 8, 24


def chain_fwd(f, x, k, b, reps: int) -> torch.Tensor:
    for _ in range(reps):
        # keep magnitudes bounded so the chain cannot overflow
        x = (f(x, k, b) * 0.1).to(x.dtype)
    return x


def chain_fwdbwd(f, x, k, b, reps: int) -> torch.Tensor:
    for _ in range(reps):
        x, k, b = (t.detach().requires_grad_() for t in (x, k, b))
        loss = (f(x, k, b).float() ** 2).sum()
        dx, dk, db = torch.autograd.grad(loss, (x, k, b))
        # chain through all the gradients
        x = (x - 1e-6 * dx.float()).to(x.dtype)
        k = k - 1e-9 * dk
        b = b - 1e-9 * db
    return x.detach()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--h", type=int, default=24)
    parser.add_argument("--w", type=int, default=24)
    parser.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    parser.add_argument("--mode", default="both",
                        choices=["fwd", "fwdbwd", "both"])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu, where both paths "
                             "run plain PyTorch")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; pass --device "
                           "cpu to run on the CPU")

    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    rng = np.random.default_rng(0)
    shape = (args.batch, args.h, args.w, 64)
    x0 = torch.from_numpy(rng.normal(0, 0.5, shape)).to(device, dt)
    k0 = torch.from_numpy(rng.normal(0, 0.05, (3, 3, 64, 64))).to(
        device, torch.float32)
    b0 = torch.from_numpy(rng.normal(0, 0.1, (64,))).to(device,
                                                        torch.float32)
    flops_per_conv = args.batch * args.h * args.w * 9 * 64 * 64 * 2

    def measure(chain, f) -> float:
        def run(reps):
            float(chain(f, x0, k0, b0, reps).float().mean())

        for reps in (REPS_LO, REPS_HI):  # warm both chain lengths
            run(reps)
        times = {}
        for reps in (REPS_LO, REPS_HI):
            for _phase in range(2):
                t0 = time.perf_counter()
                run(reps)
                times[reps] = time.perf_counter() - t0
        return (times[REPS_HI] - times[REPS_LO]) / (REPS_HI - REPS_LO)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        # throwaway measured phase: absorbs the process's first-loop cost
        measure(chain_fwd, conv_reference)
        rows = {}
        modes = ["fwd", "fwdbwd"] if args.mode == "both" else [args.mode]
        for mode in modes:
            chain = chain_fwd if mode == "fwd" else chain_fwdbwd
            # forward and backward ~= 3 convs of operations
            flops = flops_per_conv * (1 if mode == "fwd" else 3)
            t_ref = measure(chain, conv_reference)
            t_kernel = measure(chain, pair_conv)
            rows[mode] = row = {
                "mode": mode, "shape": list(shape), "dtype": args.dtype,
                "device": str(device),
                "reps": [REPS_LO, REPS_HI],
                "reference_us_per_conv": t_ref * 1e6,
                "reference_tflops": flops / t_ref / 1e12,
                "kernel_us_per_conv": t_kernel * 1e6,
                "kernel_tflops": flops / t_kernel / 1e12,
                "speedup": t_ref / t_kernel,
            }
            print(json.dumps(row), flush=True)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return rows


if __name__ == "__main__":
    main()
