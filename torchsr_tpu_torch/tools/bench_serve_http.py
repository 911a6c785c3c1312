"""Serving latency of a 1080p -> 4K frame, three tiers per backend: the
JAX package's ``tools/bench_serve_http.py`` on the port.

Backends: ``checkpoint`` (the live generator, ``CheckpointUpscaleService``),
``artifact`` (a portable ``export`` artifact, pure aten) and ``native``
(an artifact exported with ``--native-kernels``: the RDB operator, B1 on
the card), all in bf16 on the card (``--f32``: f32) with seeded random
weights.  Tiers:

1. device ms a frame: ``tiled_upscale`` through the backend's tile
   forward, the output left on the device, a scalar read back (the
   bench's protocol; compares backends);
2. direct ``_upscale`` ms a frame: adds the uint8 round and the host copy;
3. HTTP POST /upscale, PNG and JPEG: adds decode, encode and transport
   on localhost.

    python -m torchsr_tpu_torch.tools.bench_serve_http [--model esrgan]
        [--tile 64] [--tile-batch 16] [--frames 2]
        [--backends checkpoint,artifact,native] [--f32] [--blocks N]
        [--frame-hw 1080,1920] [--device cuda|cpu]

Each tier: one throwaway phase and one measured phase of ``frames``
frames; wall-clock, since the quantity is host-visible latency.  Prints
one JSON line a backend with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
import threading
import time
import urllib.request


def _timed(fn, frames: int) -> float:
    """ms a call of ``fn`` over ``frames`` calls, after a throwaway
    phase of as many."""
    for _phase in range(2):
        t0 = time.perf_counter()
        for _ in range(frames):
            fn()
        ms = (time.perf_counter() - t0) / frames * 1e3
    return ms


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="esrgan", choices=["esrgan", "srgan"])
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--tile-batch", type=int, default=16)
    ap.add_argument("--overlap", type=int, default=8)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--f32", action="store_true",
                    help="f32 compute (default: bf16 on CUDA, f32 on the "
                         "CPU)")
    ap.add_argument("--backends", default="checkpoint,artifact,native")
    ap.add_argument("--blocks", type=int, default=0)
    ap.add_argument("--frame-hw", default="1080,1920")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from torchsr_tpu_torch.infer.server import (
        CheckpointUpscaleService,
        UpscaleService,
        make_server,
    )
    from torchsr_tpu_torch.infer.serving import export_generator_artifact
    from torchsr_tpu_torch.infer.tiled import tiled_upscale
    from torchsr_tpu_torch.tools.bench import card
    from torchsr_tpu_torch.tools.bench_batching import random_checkpoint

    h, w = (int(v) for v in args.frame_hw.split(","))
    tmp = tempfile.TemporaryDirectory()
    ckpt = random_checkpoint(args.model, args.blocks or None,
                             os.path.join(tmp.name,
                                          f"{args.model}-gan-best.pth"))
    frame = np.random.default_rng(0).integers(0, 256, (h, w, 3),
                                              dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    body = buf.getvalue()
    where = card(args.device)
    rows = []
    for backend in args.backends.split(","):
        ckpt_service = CheckpointUpscaleService(
            model=args.model, checkpoint=ckpt, tile=args.tile,
            tile_batch=args.tile_batch, disable_amp=args.f32,
            device=args.device, overlap=args.overlap)
        if backend == "checkpoint":
            service = ckpt_service
            forward = service._forward
        else:
            path = os.path.join(tmp.name, f"{backend}.pt2")
            export_generator_artifact(
                path, ckpt_service._generator,
                input_hw=(args.tile, args.tile), batch=args.tile_batch,
                model=args.model, native_kernels=backend == "native")
            del ckpt_service
            service = UpscaleService(path, overlap=args.overlap,
                                     device=args.device)
            forward = service.generator._forward
        x = torch.from_numpy(frame.astype(np.float32) / 255.0).to(
            service.device)

        def run_dev():
            out = tiled_upscale(forward, x, scale=4, tile=args.tile,
                                overlap=args.overlap,
                                tile_batch=args.tile_batch)
            float(out[0, 0, 0])

        t0 = time.perf_counter()
        run_dev()
        warmup_s = time.perf_counter() - t0
        device_ms = _timed(run_dev, args.frames)
        direct_ms = _timed(lambda: service._upscale(frame, args.overlap),
                           args.frames)
        server = make_server(service, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}/upscale"
        http = {}
        try:
            for query, label in (("", "png"), ("?format=jpeg", "jpeg")):
                def post(url=base + query):
                    req = urllib.request.Request(url, data=body,
                                                 method="POST")
                    with urllib.request.urlopen(req, timeout=600) as resp:
                        return resp.read()

                http[label] = {"ms": _timed(post, args.frames),
                               "response_mb": len(post()) / 1e6}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
            service.close()
        out_mp = 16 * h * w / 1e6
        row = {"backend": backend, "model": args.model,
               "frame_hw": [h, w], "tile": args.tile,
               "tile_batch": args.tile_batch, "overlap": args.overlap,
               "compute_dtype": service.meta["compute_dtype"],
               "warmup_s": warmup_s, "device_ms": device_ms,
               "device_out_mp_per_s": out_mp / device_ms * 1e3,
               "direct_ms": direct_ms, "http": http, **where}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del service, forward
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()
    tmp.cleanup()
    return rows


if __name__ == "__main__":
    main()
