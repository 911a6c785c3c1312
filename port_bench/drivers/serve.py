"""Serving cells: frames through the port's checkpoint service.

Set-up makes the generator's weights on the card from the seed, writes
them as a checkpoint under ``TMPDIR`` (removed once loaded), starts
``infer/server.py`` ``CheckpointUpscaleService`` on it with the cell's
``service`` settings, runs its warm-up (the tile batch's CUDA graph),
and serves one frame of each size of the mix.  The window is a closed
loop of one client: each request is ``_guarded_upscale`` (the service's
device path: a uint8 frame in, the tiled forward, the blend and the
uint8 rounding on the card, the uint8 x4 frame back on the host), the
next one sent when it returns; the window closes when the request
running at ``--seconds`` returns.  ``serve_output_mp_per_s`` is every
delivered frame's output megapixels over the window's seconds,
``serve_request_p95_ms`` the 95th percentile of every request's
latency.

The check: the frames of a seeded sample of the window's requests (the
mix's largest size among them), against the reference's tiled upscale
of the same frames with the same weights in f32 (TF32 off), once the
service is freed.  The traced slice (``--trace 1``) serves one request
of each size, in the seed's order.
"""

from __future__ import annotations

import gc
import importlib
import math
import os
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

from port_bench import compare, generate, harness, trace, weights
from port_bench.reference import ops, tiling


def tile_batches(size: tuple, svc: dict) -> int:
    """Tile batches the service runs for a frame of LR ``size``."""
    stride = svc["tile"] - svc["overlap"]
    n = math.prod(len(tiling.positions(max(s, svc["tile"]), svc["tile"],
                                       stride)) for s in size)
    return -(-n // svc["tile_batch"])


def reference_frames(run, w: dict, mix: "generate.Frames", kept: dict,
                     prec: str = "f32") -> list:
    """The reference's upscale of each kept request's frame."""
    cfg, svc = run.config, run.cell["service"]
    ref = importlib.import_module(f"port_bench.reference.{cfg['family']}")

    def net(x):
        return ref.generator(w, x, cfg, prec)

    out = []
    with ops.exact_f32(), torch.no_grad():
        for i in sorted(kept):
            _size, frame = mix.request(i)
            x = torch.from_numpy(frame).to(run.device)
            out.append(tiling.upscale(
                x, net, scale=cfg["scale"], tile=svc["tile"],
                overlap=svc["overlap"],
                batch=svc["reference_batch"]).cpu().numpy())
    return out


def run(r: "harness.Run") -> "harness.Outcome":
    from torchsr_tpu_torch.infer.server import CheckpointUpscaleService
    from torchsr_tpu_torch.utils.checkpoint import save_checkpoint

    cfg, svc, dev = r.config, r.cell["service"], r.device
    ref = importlib.import_module(f"port_bench.reference.{cfg['family']}")
    w = weights.make(ref.generator_specs(cfg), r.seed, "generator", dev)
    harness.log(f"setup: weights made at "
                f"{time.perf_counter() - r.t_start:.3f} s")
    tmp = tempfile.mkdtemp(prefix="port_bench_")
    try:
        path = os.path.join(tmp, f"{cfg['name']}-seeded.pth")
        save_checkpoint(path, 1, f"{cfg['name']}-gan", w)
        service = CheckpointUpscaleService(
            cfg["family"], checkpoint=path, tile=svc["tile"],
            tile_batch=svc["tile_batch"], overlap=svc["overlap"], device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if "after_build" in r.hooks:
        r.hooks["after_build"](service)
    harness.log(f"setup: service loaded at "
                f"{time.perf_counter() - r.t_start:.3f} s")
    service.warmup()
    harness.log(f"setup: tile graph captured at "
                f"{time.perf_counter() - r.t_start:.3f} s")
    mix = generate.Frames(r.traffic, r.seed)
    overlap = svc["overlap"]
    for size in mix.sizes:  # every shape of the mix, once
        service._guarded_upscale(mix.frame(size, 0), overlap)
    harness.log(f"setup: every size served once at "
                f"{time.perf_counter() - r.t_start:.3f} s")
    check = r.cell["check"]
    sample = set(mix.sample(check["per_size"], check["decks"]))
    spans = trace.Spans()

    def serve(i: int, keep: dict | None = None) -> tuple:
        with spans("client.next"):
            size, frame = mix.request(i)
        t0 = time.perf_counter()
        try:
            with spans("request"):
                out = service._guarded_upscale(frame, overlap)
        except Exception:  # a failed request counts; the loop goes on
            traceback.print_exc()
            out = None
        t1 = time.perf_counter()
        if keep is not None and i in sample:
            keep[i] = out
        return size, out, t1 - t0, t1

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_window = time.perf_counter()
    setup_s = t_window - r.t_start
    latencies, sizes, kept = [], [], {}
    failed = bad_shape = 0
    mp = 0.0
    i = 0
    scale = cfg["scale"]
    while True:
        size, out, lat, t_end = serve(i, kept)
        latencies.append(lat)
        sizes.append(size)
        if out is None:
            failed += 1
        elif out.shape != (size[0] * scale, size[1] * scale, 3) \
                or out.dtype != np.uint8:
            bad_shape += 1
        else:
            mp += out.shape[0] * out.shape[1] / 1e6
        i += 1
        if t_end - t_window >= r.seconds:
            break
    window_s = t_end - t_window
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    notes = [f"serve: {i} requests in {window_s:.3f} s, {failed} failed, "
             f"{bad_shape} of the wrong shape; set-up {setup_s:.3f} s; "
             f"peak {memory_peak} bytes"]
    sliced = None
    if r.trace:
        slice_reqs = list(range(i, i + len(mix.sizes)))
        units = sum(tile_batches(mix.request(j)[0], svc) for j in slice_reqs)
        sliced = trace.profile(
            lambda: [serve(j) for j in slice_reqs], units=units,
            families=r.cell["slice"]["families"], calls=0,
            spans=spans, device=dev)
    del service
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refs = reference_frames(r, w, mix, kept)
    got = [kept[j] for j in sorted(kept)]
    values = compare.frames(list(zip(got, refs)))
    notes.append(f"serve: reference over {len(refs)} frames "
                 f"{[mix.request(j)[0] for j in sorted(kept)]} in "
                 f"{time.perf_counter() - t_ref:.3f} s")
    checks = harness.checks_from(values, check["limits"])
    if bad_shape or len(kept) != len(sample):
        checks.append({"name": "frames_returned", "value": float(
            bad_shape + len(sample) - len(kept)), "limit": 0.0})
    p95 = float(np.percentile(np.asarray(latencies), 95)) * 1e3
    window = {"seconds": window_s, "requests": i,
              "lr_pixels": sum(h * w_ for h, w_ in sizes)}
    return harness.Outcome(
        setup_s=setup_s,
        end_to_end={"serve_output_mp_per_s": (mp / window_s, "MP/s"),
                    "serve_request_p95_ms": (p95, "ms"),
                    "device_peak_gib": (memory_peak / 2 ** 30, "GiB")},
        window=window, checks=checks, attempted=i, failed=failed,
        memory_peak_bytes=memory_peak, slice=sliced, notes=notes)
