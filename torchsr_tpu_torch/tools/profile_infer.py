"""Anatomy of the tiled serving frame on one CUDA card: the JAX
package's ``tools/profile_infer.py`` on the port.

    python -m torchsr_tpu_torch.tools.profile_infer --model srgan   # anatomy
    python -m torchsr_tpu_torch.tools.profile_infer --model esrgan --sweep

At the serving tile shapes (ESRGAN tile 64, overlap 8, batch 16; SRGAN
tile 256, overlap 16, batch 8: the bench's), bf16, seeded random
weights.  Per tile batch, each component is timed two ways:
``chained_ms`` (CUDA events around ``--reps`` chained calls over the
count, after a throwaway phase: the device timeline a call takes, idle
gaps included) and under ``torch.profiler`` ``device_ms`` (its kernels'
summed durations a call), ``kernels`` a call and ``busy_share`` (the
device's busy share of the span from a window's first kernel to its
last; host gaps between calls show here), plus ``wall_ms`` a call.

Components:
  gen_fwd_graph  the tile batch as served: one replay of the captured
                 CUDA graph (``infer/tiled.py`` ``TileForward``)
  gen_fwd_eager  the same forward run eagerly (what the port served
                 before the graph)
  <sections>     the generator's sections, eagerly, at their inputs'
                 shapes: ESRGAN conv1, trunk (the RRDBs), conv2_skip,
                 upsample (nearest x2 + conv + LReLU, twice), head (conv3
                 + LReLU + the 64->3 conv in the model's form), and the
                 64->3 conv alone both ways: head_direct, head_subpixel;
                 SRGAN conv1, tower (the residual blocks), conv2_skip,
                 ups (the subpixel stages), tail (the stages and the
                 head as the model runs them), and the 9x9 head alone
                 both ways: head_direct (on the 4x map), head_folded
                 (the partially folded form on the last stage's
                 pre-shuffle map)
Frame probes (a 1080p -> 4K frame, ``--frames`` frames, wall ms a
frame to a scalar readback, and the profiler's busy share over one):
  frame          ``tiled_upscale`` through the graphed tile forward (the
                 production path)
  machinery      ``tiled_upscale`` with the generator stubbed to a
                 nearest 4x upsample: tile gather, copies and the blend,
                 everything but the network

``--sweep`` times the frame over ``--tiles`` x ``--batches`` instead.
One JSON line on stdout, with the card's name and power limit.
``--device cpu`` with ``--blocks`` and ``--frame-hw`` rehearses it on
the CPU: wall times only, which are not the card's.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def _wall_ms(fn, reps: int) -> float:
    fn()
    _sync()
    for _phase in range(2):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync()
        ms = (time.perf_counter() - t0) / reps * 1e3
    return ms


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def measure(fns: dict, reps: int, cuda: bool) -> dict:
    """Each call's wall ms; on CUDA also its chained ms and profile."""
    rows = {}
    for name, fn in fns.items():
        row = {"wall_ms": _wall_ms(fn, reps)}
        if cuda:
            from torchsr_tpu_torch.tools.bench_rdb import _profile
            from torchsr_tpu_torch.tools.profile_gan_step import chained_ms

            prof = _profile(torch, fn, 3)
            row.update(chained_ms=chained_ms(fn, reps),
                       device_ms=prof["device_ms"],
                       kernels=prof["kernels_per_call"],
                       busy_share=prof["busy_share_of_span"])
        rows[name] = row
    return rows


def sections(gen, x: torch.Tensor) -> dict:
    """The generator's sections as calls on their own inputs (computed
    once from ``x``), eagerly under inference mode."""
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
    from torchsr_tpu_torch.models.layers import leaky_relu
    from torchsr_tpu_torch.ops.resize import nearest_upsample
    from torchsr_tpu_torch.ops.subpixel_conv import (
        conv_head_partially_folded,
    )

    with torch.inference_mode():
        xc = x.to(gen.compute_dtype or torch.float32)
        if isinstance(gen, ESRGANGenerator):
            c1 = gen.conv1(xc).contiguous()
            trunk = gen.blocks(c1)
            mid = c1 + gen.conv2(trunk)
            up = mid
            for conv in gen.upsamplers():
                up = leaky_relu(conv(nearest_upsample(up, 2)), 0.2)

            def upsample():
                out = mid
                for conv in gen.upsamplers():
                    out = leaky_relu(conv(nearest_upsample(out, 2)), 0.2)
                return out

            pre = leaky_relu(gen.conv3[0](up), 0.2)
            calls = {
                "conv1": lambda: gen.conv1(xc),
                "trunk": lambda: gen.blocks(c1),
                "conv2_skip": lambda: c1 + gen.conv2(trunk),
                "upsample": upsample,
                "head": lambda: gen.head(
                    leaky_relu(gen.conv3[0](up), 0.2)).float(),
                "head_direct": lambda: gen.head(pre, False),
                "head_subpixel": lambda: gen.head(pre, True),
            }
        else:
            c1 = gen.conv1(xc)
            tower = gen.blocks(c1)
            mid = gen.conv2(tower) + c1
            up = gen.conv_layers(mid)
            folded = gen.conv_layers[-1](gen.conv_layers[:-1](mid),
                                         shuffle=False)
            calls = {
                "conv1": lambda: gen.conv1(xc),
                "tower": lambda: gen.blocks(c1),
                "conv2_skip": lambda: gen.conv2(tower) + c1,
                "ups": lambda: gen.conv_layers(mid),
                "tail": lambda: gen.tail(mid).float(),
                "head_direct": lambda: gen.head(up, False),
                "head_folded": lambda: conv_head_partially_folded(
                    folded, gen.conv3.weight, gen.conv3.bias, 4, 2),
            }

    def inference(fn):
        def call():
            with torch.inference_mode():
                return fn()
        return call

    return {k: inference(v) for k, v in calls.items()}


def _frame_row(forward, frame, tile, overlap, batch, frames,
               cuda: bool) -> dict:
    from torchsr_tpu_torch.infer.tiled import tiled_upscale

    def run():
        out = tiled_upscale(forward, frame, scale=4, tile=tile,
                            overlap=overlap, tile_batch=batch)
        float(out[0, 0, 0])

    ms = _wall_ms(run, frames)
    h, w = frame.shape[:2]
    row = {"wall_ms": ms, "output_mp_per_s": 16 * h * w / 1e3 / ms}
    if cuda:
        from torchsr_tpu_torch.tools.bench_rdb import _profile

        prof = _profile(torch, run, 1)
        row.update(device_ms=prof["device_ms"],
                   kernels=prof["kernels_per_call"],
                   busy_share=prof["busy_share_of_span"])
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="srgan", choices=["srgan", "esrgan"])
    ap.add_argument("--tile", type=int, default=0,
                    help="LR tile (default: the serving tile)")
    ap.add_argument("--overlap", type=int, default=0,
                    help="default: 16 srgan / 8 esrgan")
    ap.add_argument("--tile-batch", type=int, default=0,
                    help="default: 8 srgan / 16 esrgan")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--components", default="",
                    help="comma-separated subset (default: all)")
    ap.add_argument("--sweep", action="store_true",
                    help="tile x tile-batch frame sweep instead")
    ap.add_argument("--tiles", default="",
                    help="sweep tiles (default: 48,64,96,128 ESRGAN; "
                         "128,192,256 SRGAN)")
    ap.add_argument("--batches", default="4,8,16")
    ap.add_argument("--blocks", type=int, default=0)
    ap.add_argument("--frame-hw", default="1080,1920")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    only = set(filter(None, args.components.split(",")))

    import numpy as np

    from torchsr_tpu_torch.infer.tiled import (
        DEFAULT_SERVING_TILE,
        tile_forward,
    )
    from torchsr_tpu_torch.tools.bench import _generator, card

    esr = args.model == "esrgan"
    tile = args.tile or DEFAULT_SERVING_TILE[args.model]
    overlap = args.overlap or (8 if esr else 16)
    batch = args.tile_batch or (16 if esr else 8)
    gen, device = _generator(args.model, args.device, args.blocks or None)
    cuda = device.type == "cuda"
    h, w = (int(v) for v in args.frame_hw.split(","))
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.random((h, w, 3)).astype(np.float32)).to(
        device)
    out = {"model": args.model, "tile": tile, "overlap": overlap,
           "tile_batch": batch, "frame_hw": [h, w],
           "compute_dtype": str(gen.compute_dtype).removeprefix("torch."),
           **card(device)}

    if args.sweep:
        tiles = args.tiles or ("48,64,96,128" if esr else "128,192,256")
        rows = []
        for t in (int(v) for v in tiles.split(",")):
            for b in (int(v) for v in args.batches.split(",")):
                row = _frame_row(tile_forward(gen, device), frame, t,
                                 min(overlap, t - 1), b, args.frames, cuda)
                rows.append({"tile": t, "tile_batch": b, **row})
                print(json.dumps(rows[-1]), flush=True)
                if cuda:
                    torch.cuda.empty_cache()
        out["sweep"] = rows
        print(json.dumps(out), flush=True)
        return out

    x = torch.from_numpy(rng.random((batch, tile, tile, 3)).astype(
        np.float32)).to(device)
    forward = tile_forward(gen, device)

    def eager():
        with torch.inference_mode():
            return gen(x)

    fns = {"gen_fwd_graph": lambda: forward(x), "gen_fwd_eager": eager,
           **sections(gen, x)}
    fns = {k: v for k, v in fns.items() if not only or k in only}
    out["components"] = measure(fns, args.reps, cuda)

    def nearest4x(batch_x):
        return batch_x.repeat_interleave(4, 1).repeat_interleave(4, 2)

    frames = {"frame": forward, "machinery": nearest4x}
    out["frame_probes"] = {
        k: _frame_row(fn, frame, tile, overlap, batch, args.frames, cuda)
        for k, fn in frames.items() if not only or k in only}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
