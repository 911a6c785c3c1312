"""Small-frame serving throughput, dynamic batching off and on: the JAX
package's ``tools/bench_batching.py`` on the port.

The case ``serve --batch-requests`` exists for: many concurrent clients
posting frames at or below one tile, where a frame's own tile batch is
mostly padding.  The tool drives ``CheckpointUpscaleService`` directly
(no HTTP; ``bench_serve_http.py`` covers transport) with M client
threads x K requests of a tile-sized PNG, batching off and then on, and
reports frames/s and the batcher's measured fill (tiles a forward over
``tile_batch``).

    python -m torchsr_tpu_torch.tools.bench_batching [--model srgan]
        [--tile 64] [--tile-batch 16] [--clients 16] [--requests 8]
        [--frame N] [--wait-ms 2] [--device cuda|cpu] [--blocks N]

Timing is wall-clock over all requests: the quantity is host-visible
request throughput (decode, queueing, device, encode).  One throwaway
phase, then one measured phase, per setting.  The weights are a seeded
random checkpoint unless ``--checkpoint`` names one.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
import threading
import time


def random_checkpoint(model: str, blocks: int | None, path: str) -> str:
    """A checkpoint of seeded random ``model`` weights at ``path``."""
    import torch

    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
    from torchsr_tpu_torch.models.srgan import SRGANGenerator
    from torchsr_tpu_torch.utils.checkpoint import save_checkpoint

    seeded = torch.Generator().manual_seed(0)
    if model == "esrgan":
        gen = ESRGANGenerator(num_rrdb_blocks=blocks or 23, generator=seeded)
    else:
        gen = SRGANGenerator(num_residual=blocks or 16, generator=seeded)
    save_checkpoint(path, 1, "gan", gen.state_dict())
    return path


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="srgan", choices=["srgan", "esrgan"])
    ap.add_argument("--checkpoint", type=str, default="")
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--tile-batch", type=int, default=16)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per client per measured phase")
    ap.add_argument("--frame", type=int, default=0,
                    help="LR frame edge (default: --tile, one tile)")
    ap.add_argument("--wait-ms", type=float, default=2.0)
    ap.add_argument("--blocks", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    from PIL import Image

    from torchsr_tpu_torch.infer.server import CheckpointUpscaleService
    from torchsr_tpu_torch.tools.bench import card

    frame = args.frame or args.tile
    rng = np.random.default_rng(0)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (frame, frame, 3),
                                 dtype=np.uint8)).save(buf, format="PNG")
    png = buf.getvalue()
    tmp = tempfile.TemporaryDirectory()
    ckpt = args.checkpoint or random_checkpoint(
        args.model, args.blocks or None,
        os.path.join(tmp.name, f"{args.model}-gan-best.pth"))

    def run(batching: bool) -> tuple[float, dict]:
        service = CheckpointUpscaleService(
            model=args.model, checkpoint=ckpt, tile=args.tile,
            tile_batch=args.tile_batch, batch_requests=batching,
            batch_wait_ms=args.wait_ms, max_pending=0, device=args.device,
        )
        service.warmup()

        def client(n: int) -> None:
            for _ in range(n):
                service.upscale_bytes(png, fmt="png", compress=1)

        def phase() -> float:
            threads = [threading.Thread(target=client,
                                        args=(args.requests,))
                       for _ in range(args.clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return time.perf_counter() - t0

        phase()  # throwaway phase
        wall = phase()
        stats = service.metrics()
        service.close()
        return args.clients * args.requests / wall, stats

    try:
        fps_off, _ = run(False)
        fps_on, stats = run(True)
    finally:
        tmp.cleanup()
    where = card(args.device)
    fill = stats.get("batch_fill_mean")
    row = {"model": args.model, "tile": args.tile,
           "tile_batch": args.tile_batch, "clients": args.clients,
           "requests": args.requests, "frame": frame,
           "frames_per_s_off": fps_off, "frames_per_s_on": fps_on,
           "speedup": fps_on / fps_off, "batch_fill_mean": fill,
           "tiles_per_forward": (stats["batched_tiles"]
                                 / stats["batched_calls"]),
           **where}
    print(f"{args.model} tile={args.tile} batch={args.tile_batch} "
          f"{args.clients} clients x {args.requests} req of {frame}px "
          f"frames on {where['device']}, {where['power_limit_w']} W:")
    print(f"  batching OFF: {fps_off:8.1f} frames/s")
    print(f"  batching ON : {fps_on:8.1f} frames/s ({fps_on / fps_off:.2f}x,"
          f" mean batch fill {fill})")
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
