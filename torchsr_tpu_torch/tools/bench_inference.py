"""Tiled 4x upscale throughput, 1080p -> 4K, in input megapixels a
second: the JAX package's ``tools/bench_inference.py`` on the port.

    python -m torchsr_tpu_torch.tools.bench_inference [--model srgan|esrgan]
        [--tile 64] [--overlap 16] [--tile-batch 8] [--blocks N]
        [--frames 3] [--device cuda|cpu] [--frame-hw 1080,1920]

The generator has seeded random weights (throughput does not depend on
their values) and computes in bf16 on CUDA (f32 on the CPU); frames go
through ``infer/tiled.py`` ``tiled_upscale`` with the server's tile
forward (``tile_forward``: on CUDA each tile batch replays one captured
CUDA graph).  One warm-up frame (it captures the graph), then ``frames``
frames timed to a scalar readback.  ``--frame-hw`` and ``--blocks``
shrink the run for the CPU, whose numbers are not the card's.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", default="esrgan",
                        choices=["srgan", "esrgan"])
    parser.add_argument("--tile", type=int, default=0,
                        help="0 = 64 for ESRGAN (the RDB kernel's serving "
                             "shape), 128 for SRGAN (the JAX tool's).")
    parser.add_argument("--overlap", type=int, default=16)
    parser.add_argument("--tile-batch", type=int, default=8)
    parser.add_argument("--blocks", type=int, default=0,
                        help="generator blocks (0 = full size)")
    parser.add_argument("--frames", type=int, default=3)
    parser.add_argument("--frame-hw", default="1080,1920")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if not args.tile:
        args.tile = 64 if args.model == "esrgan" else 128
    h, w = (int(v) for v in args.frame_hw.split(","))

    import numpy as np
    import torch

    from torchsr_tpu_torch.infer.tiled import tile_forward, tiled_upscale
    from torchsr_tpu_torch.tools.bench import _generator, card

    gen, device = _generator(args.model, args.device, args.blocks or None)
    forward = tile_forward(gen, device)
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(
        rng.random((h, w, 3)).astype(np.float32)).to(device)

    def run():
        return tiled_upscale(forward, frame, scale=4, tile=args.tile,
                             overlap=args.overlap,
                             tile_batch=args.tile_batch)

    t0 = time.perf_counter()
    out = run()
    float(out.mean())  # the readback is the completion barrier
    warmup_s = time.perf_counter() - t0
    assert tuple(out.shape) == (4 * h, 4 * w, 3)
    t0 = time.perf_counter()
    for _ in range(args.frames):
        out = run()
    float(out.mean())
    per_frame = (time.perf_counter() - t0) / args.frames
    mp_in = h * w / 1e6
    where = card(device)
    print(
        f"{args.model} tiled {h}p->4x: {per_frame * 1e3:.0f} ms/frame "
        f"({mp_in / per_frame:.2f} MP/s in, {mp_in * 16 / per_frame:.1f} "
        f"MP/s out, {1 / per_frame:.2f} fps; tile={args.tile} "
        f"overlap={args.overlap} batch={args.tile_batch}; warm-up "
        f"{warmup_s:.1f}s; {where['device']}, {where['power_limit_w']} W)",
        flush=True)
    return {"ms_per_frame": per_frame * 1e3,
            "input_mp_per_s": mp_in / per_frame,
            "output_mp_per_s": 16 * mp_in / per_frame, **where}


if __name__ == "__main__":
    main()
