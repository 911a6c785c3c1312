#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's ESRGAN serving path once on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 chip_smoke.py [--seed N]

Phases, one line each:

1. probe: requires a CUDA device; prints its name and power limit.
2. build: compiles ``torchsr_tpu_torch/ops/csrc/rdb_fwd.cu`` with nvcc.
3. rdb_fwd: the RDB kernel at the serving shape (16 tiles of 64x64, 64
   channels) and at a ragged shape, in f32 and bf16.  Each of its five
   launches is held against its own convolution of the feature buffer
   the kernel filled, and the block against its plain PyTorch version;
   each check also prints what a wrong kernel reads under its limit.
   Median times over 30 calls (CUDA events) beside the card's bound.
4. generator: the full-width 23-RRDB ESRGAN (seeded random weights) on
   one tile batch, kernel path against plain path in f32 and in bf16,
   both timed in bf16, and a ``profile`` line: ``torch.profiler``'s
   device time per kernel class over three tile batches.
5. serve, the main path: the weights saved as a .pth,
   ``CheckpointUpscaleService`` on ``cuda`` behind ``make_server``, three
   PNG requests over HTTP.  The kernel's launch counter is reset just
   before the requests and must read 5 x 69 x the tile batches run; the
   answers are held against the same tiling of the generator.
6. test: ``python -m torchsr_tpu_torch test`` (called in this process)
   on one image, whole-image and tiled, the counter reset before each.

Then a ``kernels`` JSON line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no last line.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from torchsr_tpu_torch import cli  # noqa: E402
from torchsr_tpu_torch.infer.server import (  # noqa: E402
    CheckpointUpscaleService,
    make_server,
)
from torchsr_tpu_torch.infer.tiled import _positions, tiled_upscale  # noqa: E402
from torchsr_tpu_torch.models.esrgan import (  # noqa: E402
    ESRGANGenerator,
    ResidualDenseBlock,
)
from torchsr_tpu_torch.models.layers import leaky_relu  # noqa: E402
from torchsr_tpu_torch.ops import _build  # noqa: E402
from torchsr_tpu_torch.ops import rdb as rdb_ops  # noqa: E402
from torchsr_tpu_torch.ops.resize import nearest_upsample  # noqa: E402
from torchsr_tpu_torch.utils.checkpoint import save_checkpoint  # noqa: E402

# H100 SXM published peaks (dense): the bound of a kernel is the larger
# of its bytes over HBM bandwidth and its operations over the peak rate
# of their type.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12
RDB_FLOP_PER_PX = 2 * 9 * sum(
    ci * co for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT)
)  # 479,232
SERVE_RDB_SHAPE = (16, 64, 64, 64)  # tile_batch 16 of 64 px LR tiles
RAGGED = (3, 37, 45)  # partial CTA tiles, as the whole-image `test` gives
SCALE = 0.2  # the blocks' residual scale
NUM_RRDB = 23
# Per-element limits.  A result passes when at every element
#     |got - ref| <= rel * |ref| + frac * max|ref - base|,
# where max|ref - base| is the largest value the checked computation
# adds: a launch's output (base 0), or the block's residual
# scale * conv5 (base x).  "excess" is the largest ratio of the left
# side to the right, and at most 1 passes.  Beside each, the excess of
# a wrong result is printed (a grown slice left at zero, conv5 skipped):
# it must exceed 1, or the limit could not see that fault.
#
# A launch against the same convolution (f32, TF32 off) of the feature
# buffer the kernel itself filled.  f32 differs in summation order only
# (~1e-7 of the values); bf16 also rounds once to bf16, at most 2^-8 of
# the value, and rel 2^-7 allows a tie rounded the other way.
STAGE_LIMITS = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2**-7, 1e-3)}
# The block against its plain version in f32 on the same inputs.  In
# bf16 the four rounded intermediates (2^-9 of their values on average)
# also feed conv5, so frac is 2^-5 of the largest residual.
BLOCK_LIMITS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2**-7, 2**-5)}
# The whole generator in f32, kernel path against plain path on the
# same weights: 351 convs summed in other orders.  Limits on the
# generator are fractions of the largest output value of its f32 plain
# path.
TOL_GEN_F32 = 1e-5
# The generator in bf16 against that f32 plain path.  At the model's
# own init (RDB kernels kaiming-normal x 0.1) what the blocks add to the
# output is of the order of the bf16 rounding of the input and of the
# other convs, so this limit bounds gross errors only.  With the
# blocks' convs at torch's default init they add more, and there the
# bf16 kernel path is also held against the bf16 plain path (the same
# rounding of the input and of the other convs) to a fraction of what
# a generator with wrong blocks reads against the f32 plain path.
TOL_GEN_BF16 = 0.05
GEN_BF16_FRAC = 0.25
# A served frame against the same tiling of the generator, both rounded
# to uint8: the same computation, so at most a rounding tie apart.
TOL_SERVE_LEVELS = 1
REQUEST_SIZES = ((64, 64), (128, 160), (120, 200))
TEST_IMAGE = (100, 140)
DEVICE = "cuda"


def say(phase: str, **fields) -> None:
    print(f"{phase}: {json.dumps(fields)}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def rdb_bound_ms(shape, dtype) -> tuple[float, str]:
    b, h, w, c = shape
    px = b * h * w
    item = torch.finfo(dtype).bits // 8
    weights = sum(9 * ci * co for ci, co in zip(rdb_ops.CIN, rdb_ops.COUT))
    nbytes = 2 * px * c * item + weights * item + 4 * sum(rdb_ops.COUT)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = px * RDB_FLOP_PER_PX / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), (
        "bytes" if t_bytes > t_ops else "operations")


def excess(got, ref, limits, base=None) -> float:
    """The largest ratio |got - ref| / (rel |ref| + frac max|ref - base|)
    over the elements; at most 1 passes."""
    rel, frac = limits
    scale = (ref if base is None else ref - base).abs().max()
    return float(((got - ref).abs() / (rel * ref.abs() + frac * scale)).max())


def conv3x3(f: torch.Tensor, k: torch.Tensor, b: torch.Tensor):
    """SAME 3x3 conv of NHWC ``f`` by HWIO ``k``, in ``f.dtype``."""
    return F.conv2d(f.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(f.dtype),
                    b.to(f.dtype), padding=1).permute(0, 2, 3, 1)


def conv5_skipped(y, kernels, biases, *, scale_ratio):
    """A wrong block that lost its residual: it returns its input."""
    return y


def grown_zero(y, kernels, biases, *, scale_ratio):
    """A wrong block whose launches 1-4 wrote zeros: conv5 sees x only."""
    grown = rdb_ops.FEAT - rdb_ops.CHANNELS
    return y + scale_ratio * conv3x3(F.pad(y, (0, grown)), kernels[4],
                                     biases[4])


WRONG_BLOCKS = {"conv5_skipped": conv5_skipped, "grown_zero": grown_zero}


def plain_generator(gen: ESRGANGenerator, x: torch.Tensor,
                    block=rdb_ops.rdb_reference) -> torch.Tensor:
    """The generator's forward with every residual dense block on
    ``block`` (by default the plain version, five cuDNN convolutions)
    instead of the kernel."""
    x = x.to(gen.compute_dtype or torch.float32)
    conv1 = gen.conv1(x).contiguous()
    out = conv1
    for rrdb in gen.blocks:
        y = out
        for rdb in (rrdb.RDB1, rrdb.RDB2, rrdb.RDB3):
            convs = rdb.convs()
            y = block(y, [c.weight.permute(2, 3, 1, 0) for c in convs],
                      [c.bias for c in convs], scale_ratio=rdb.scale_ratio)
        out = y * rrdb.scale_ratio + out
    out = conv1 + gen.conv2(out)
    for up in gen.upsamplers():
        out = leaky_relu(up(nearest_upsample(out, 2)), 0.2)
    out = leaky_relu(gen.conv3[0](out), 0.2)
    return gen.conv4(out).float()


def phase_probe() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
            "is False"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("probe", device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build("rdb_fwd")
    regs, name = [], None
    for line in (built or {}).get("ptxas", []):
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"conv3x3_(\w+?)ILi(\d+)ELi(\d+)E", name)
            if t:
                name = f"{t.group(1)}/{t.group(2)}->{t.group(3)}"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs.append(f"{name}:{m.group(1)}r")
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and m.group(1) != "0":
            regs.append(f"{name}:SPILL{m.group(1)}")
    _build.load_library("rdb_fwd")
    say("build", seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=built and round(built["seconds"], 3), ptxas=regs)


def _rdb_weights(gen: torch.Generator, device):
    convs = ResidualDenseBlock().convs()
    for conv in convs:
        conv.reset_parameters(gen)
    ks = [c.weight.detach().permute(2, 3, 1, 0).contiguous().to(device)
          for c in convs]
    bs = [c.bias.detach().to(device) for c in convs]
    return ks, bs


def hold_rdb(x: torch.Tensor, ks, bs) -> dict:
    """One ``fused_rdb`` on the card, each launch and the whole block
    held against plain convolutions in f32 (see the limits above)."""
    before = rdb_ops.RDB_FWD_LAUNCHES
    out, feat = rdb_ops.rdb_fwd_cuda(x, ks, bs, scale_ratio=SCALE)
    check(rdb_ops.RDB_FWD_LAUNCHES == before + 5,
          "fused_rdb launched its kernel five times")
    check(bool(torch.isfinite(out).all()), "rdb_fwd output finite")
    row = rdb_scores(x, ks, bs, out, feat)
    name = f"rdb_fwd {x.dtype} {tuple(x.shape)}"
    check(max(row["stage_excess"]) <= 1 and row["block_excess"] <= 1,
          f"{name} within its limits: {row}")
    check(min(row["stage_wrong_excess"]) > 1
          and min(row["block_wrong_excess"].values()) > 1,
          f"{name}: the limits see a wrong kernel: {row}")
    return row


def rdb_scores(x: torch.Tensor, ks, bs, out: torch.Tensor,
               feat: torch.Tensor) -> dict:
    """The excess of each launch of a block (``feat``: the feature
    buffer it filled, ``out``: its output) and of the whole block, and
    of the wrong results beside them."""
    limits = STAGE_LIMITS[x.dtype]
    xf, f, out = x.float(), feat.float(), out.float()
    stages, stages_wrong = [], []
    for i, (cin, cout) in enumerate(zip(rdb_ops.CIN, rdb_ops.COUT)):
        ref = conv3x3(f[..., :cin], ks[i].float(), bs[i])
        if i < 4:  # launch i appended channels [cin, cin + 32)
            ref = F.leaky_relu(ref, 0.2)
            got, wrong, base = f[..., cin:cin + cout], 0 * ref, None
        else:  # launch 5 wrote x + scale * conv5
            ref = xf + SCALE * ref
            got, wrong, base = out, xf, xf
        stages.append(excess(got, ref, limits, base))
        stages_wrong.append(excess(wrong, ref, limits, base))
    limits = BLOCK_LIMITS[x.dtype]
    kf = [k.float() for k in ks]
    ref = rdb_ops.rdb_reference(xf, kf, bs, scale_ratio=SCALE)
    block_wrong = {name: excess(fn(xf, kf, bs, scale_ratio=SCALE), ref,
                                limits, xf)
                   for name, fn in WRONG_BLOCKS.items()}
    return {
        "max_abs_err": float((out - ref).abs().max()),
        "block_excess": excess(out, ref, limits, xf),
        "block_wrong_excess": block_wrong,
        "stage_excess": stages,
        "stage_wrong_excess": stages_wrong,
    }


def phase_rdb(seed: int) -> dict:
    dev = torch.device(DEVICE)
    g = torch.Generator().manual_seed(seed)
    ks, bs = _rdb_weights(g, dev)
    x = (torch.randn(SERVE_RDB_SHAPE, generator=g) * 0.5).to(dev)
    b, h, w = RAGGED
    rows = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            kd = [k.to(dtype) for k in ks]
            row = hold_rdb(xd, kd, bs)
            row["ragged"] = hold_rdb(xd[:b, :h, :w], kd, bs)
            row["ms"] = median_ms(lambda: rdb_ops.fused_rdb(xd, kd, bs))
            row["plain_ms"] = median_ms(
                lambda: rdb_ops.rdb_reference(xd, kd, bs))
            row["bound_ms"], row["bound_by"] = rdb_bound_ms(SERVE_RDB_SHAPE,
                                                            dtype)
            row["tflops"] = (SERVE_RDB_SHAPE[0] * 64 * 64 * RDB_FLOP_PER_PX
                             / row["ms"] / 1e9)
            name = str(dtype).removeprefix("torch.")
            rows[name] = row
            say(f"rdb_fwd[{name}]", shape=list(SERVE_RDB_SHAPE),
                ragged_shape=[*RAGGED, 64], stage_limits=STAGE_LIMITS[dtype],
                block_limits=BLOCK_LIMITS[dtype], **row)
    return rows


def _kernel_class(name: str) -> str:
    if "conv3x3_bf16" in name or "conv3x3_f32" in name:
        return "rdb_fwd"
    low = name.lower()
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "gemm")):
        return "other_conv"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copy"
    if "elementwise" in low or "vectorized" in low or "reduce" in low:
        return "elementwise"
    return "other"


def profile_device_time(gen: ESRGANGenerator, x: torch.Tensor,
                        batches: int = 3) -> dict:
    """Device time per kernel class over ``batches`` forwards, and the
    device's busy share of the span from the first kernel to the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(batches):
            gen(x)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    check(bool(spans), "the profiler recorded device events")
    by_class: dict = {}
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, name in spans:
        cls = _kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + (end - start) / 1e3
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    total = sum(by_class.values())
    return {
        "batches": batches,
        "device_ms_per_batch": {k: v / batches for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        "share": {k: v / total for k, v in by_class.items()},
        "kernels_per_batch": len(spans) / batches,
        "busy_share_of_span": busy / (spans[-1][1] - spans[0][0]),
    }


def _dist(a: torch.Tensor, b: torch.Tensor) -> dict:
    d = (a - b).abs()
    return {"max": float(d.max()), "mean": float(d.mean())}


def hold_generator(gen: ESRGANGenerator, x: torch.Tensor) -> dict:
    """The generator's kernel path in f32 and bf16 against its plain
    path in f32, and what generators with wrong blocks read there (max
    and mean absolute differences)."""
    with torch.inference_mode():
        gen.compute_dtype = None
        out = gen(x)
        check(tuple(out.shape) == (x.shape[0], 256, 256, 3),
              "generator 4x shape")
        check(bool(torch.isfinite(out).all()), "generator output finite")
        ref = plain_generator(gen, x)
        row = {"f32_vs_f32_plain": _dist(out, ref)}
        gen.compute_dtype = torch.bfloat16
        out = gen(x)
        row["bf16_vs_f32_plain"] = _dist(out, ref)
        row["bf16_vs_bf16_plain"] = _dist(out, plain_generator(gen, x))
        gen.compute_dtype = None
        row["wrong_block_vs_f32_plain"] = {
            name: _dist(plain_generator(gen, x, fn), ref)
            for name, fn in WRONG_BLOCKS.items()}
    scale = float(ref.abs().max())
    row["f32_limit"] = TOL_GEN_F32 * scale
    row["bf16_limit"] = TOL_GEN_BF16 * scale
    row["out_range"] = [float(ref.min()), float(ref.max())]
    check(row["f32_vs_f32_plain"]["max"] <= row["f32_limit"],
          f"generator f32: {row}")
    check(min(d["max"] for d in row["wrong_block_vs_f32_plain"].values())
          > row["f32_limit"],
          f"the f32 limit sees a generator with wrong blocks: {row}")
    check(row["bf16_vs_f32_plain"]["max"] <= row["bf16_limit"],
          f"generator bf16: {row}")
    return row


def phase_generator(seed: int, rdb_bf16_ms: float) -> ESRGANGenerator:
    dev = torch.device(DEVICE)
    gen = ESRGANGenerator(
        num_rrdb_blocks=NUM_RRDB, generator=torch.Generator().manual_seed(seed)
    ).to(dev).requires_grad_(False)
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.rand((16, 64, 64, 3), generator=g).to(dev)
    rows = {"model_init": hold_generator(gen, x)}
    # the same generator with the blocks' convs at torch's default init
    visible = ESRGANGenerator(num_rrdb_blocks=NUM_RRDB, device="meta")
    visible.load_state_dict({k: v.clone() for k, v in
                             gen.state_dict().items()}, assign=True)
    for m in visible.blocks.modules():
        if isinstance(m, ResidualDenseBlock):
            for conv in m.convs():
                conv.kernel_std = None
                conv.reset_parameters(g)
    rows["rdb_default_init"] = row = hold_generator(
        visible.requires_grad_(False), x)
    del visible
    row["bf16_vs_bf16_plain_mean_limit"] = limit = GEN_BF16_FRAC * min(
        d["mean"] for d in row["wrong_block_vs_f32_plain"].values())
    check(row["bf16_vs_bf16_plain"]["mean"] <= limit,
          f"generator bf16 within {GEN_BF16_FRAC} of a wrong block: {row}")
    with torch.inference_mode():
        gen.compute_dtype = torch.bfloat16
        ms = median_ms(lambda: gen(x), reps=5, warmup=1)
        plain_ms = median_ms(lambda: plain_generator(gen, x), reps=5,
                             warmup=1)
        prof = profile_device_time(gen, x)
    say("generator", rrdb=NUM_RRDB, params=sum(p.numel()
                                               for p in gen.parameters()),
        tile_batch=list(x.shape), **rows, bf16_ms=ms,
        bf16_plain_ms=plain_ms,
        bf16_output_mp_per_s=x.shape[0] * 256 * 256 / 1e6 / (ms / 1e3),
        # the 3 * 23 residual dense blocks at the rdb_fwd phase's time
        rdb_share_of_bf16_ms=3 * NUM_RRDB * rdb_bf16_ms / ms)
    say("profile", tile_batch=list(x.shape), dtype="bfloat16", **prof)
    return gen


def _png(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _unpng(body: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)))


def _levels(a: np.ndarray, b: np.ndarray) -> dict:
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return {"mean": float(diff.mean()), "max": int(diff.max())}


def phase_serve(gen: ESRGANGenerator, ckpt: str, seed: int) -> int:
    service = CheckpointUpscaleService(model="esrgan", checkpoint=ckpt,
                                       device=DEVICE)
    t0 = time.perf_counter()
    server = make_server(service, port=0)
    warmup_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for h, w in REQUEST_SIZES]
    bodies = [_png(f) for f in frames]
    tile, batch = service.tile, service.tile_batch
    overlap = service._resolve_overlap(None)
    batches = 0
    latencies = []
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            check(resp.status == 200, "/healthz 200 after warmup")
        rdb_ops.RDB_FWD_LAUNCHES = 0  # the main path starts here
        answers = []
        for frame, body in zip(frames, bodies):
            h, w = frame.shape[:2]
            n_tiles = (len(_positions(max(h, tile), tile, tile - overlap))
                       * len(_positions(max(w, tile), tile, tile - overlap)))
            batches += -(-n_tiles // batch)
            req = urllib.request.Request(base + "/upscale", data=body,
                                         method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as resp:
                check(resp.status == 200, "/upscale 200")
                answers.append(_unpng(resp.read()))
            latencies.append((time.perf_counter() - t0) * 1e3)
        launches = rdb_ops.RDB_FWD_LAUNCHES
        with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
            metrics = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    for frame, sr in zip(frames, answers):
        h, w = frame.shape[:2]
        check(sr.shape == (4 * h, 4 * w, 3) and sr.dtype == np.uint8,
              f"answer for {h}x{w} is a {4 * h}x{4 * w} RGB uint8 image")
        check(int(sr.max()) > int(sr.min()), "answer is not constant")
    expected = 5 * 3 * NUM_RRDB * batches
    check(launches == expected,
          f"rdb_fwd launches on the main path {launches} == {expected}")
    check(metrics["requests"] == len(frames) and metrics["errors"] == 0,
          "/metrics counts the requests")

    def tiling(fn, frame):
        x = torch.from_numpy(frame).to(DEVICE).float() / 255.0
        out = tiled_upscale(fn, x, scale=4, tile=tile, overlap=overlap,
                            tile_batch=batch)
        return (out.clamp(0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()

    # each answer against the same tiling of the generator (bf16, the
    # kernel path); the first frame also against the f32 plain
    # generator and against a generator whose blocks lost conv5
    with torch.inference_mode():
        gen.compute_dtype = torch.bfloat16
        vs_direct = [_levels(sr, tiling(gen, f))
                     for f, sr in zip(frames, answers)]
        gen.compute_dtype = None
        ref = tiling(lambda b: plain_generator(gen, b), frames[0])
        wrong = tiling(lambda b: plain_generator(gen, b, conv5_skipped),
                       frames[0])
    say("serve", sizes=[list(s) for s in REQUEST_SIZES],
        warmup_s=warmup_s, request_ms=latencies, tile_batches=batches,
        rdb_fwd_launches=launches, vs_same_tiling_levels=vs_direct,
        first_vs_f32_plain_levels=_levels(answers[0], ref),
        conv5_skipped_vs_f32_plain_levels=_levels(wrong, ref),
        metrics=metrics, meta=service.meta)
    check(max(d["max"] for d in vs_direct) <= TOL_SERVE_LEVELS,
          f"served frames within {TOL_SERVE_LEVELS} level of the "
          f"generator's own tiling: {vs_direct}")
    return launches


def phase_test(ckpt: str, seed: int) -> None:
    """The ``test`` subcommand through the CLI's own ``main``."""
    from PIL import Image

    workdir = os.path.dirname(ckpt)
    frame = np.random.default_rng(seed + 2).integers(
        0, 256, (*TEST_IMAGE, 3), dtype=np.uint8)
    Image.fromarray(frame).save(os.path.join(workdir, "photo.png"))
    h, w = TEST_IMAGE
    overlap = 16  # the test subcommand's default --tile-overlap
    tiles = (len(_positions(h, 64, 64 - overlap))
             * len(_positions(w, 64, 64 - overlap)))
    rows = []
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for extra, batches in (([], 1),
                               (["--tile", "64", "--tile-batch", "16"],
                                -(-tiles // 16))):
            rdb_ops.RDB_FWD_LAUNCHES = 0
            t0 = time.perf_counter()
            cli.main(["test", "photo.png", "--checkpoint", ckpt, *extra])
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = rdb_ops.RDB_FWD_LAUNCHES
            with Image.open("upres-photo.png") as img:
                sr = np.asarray(img)
            check(sr.shape == (4 * h, 4 * w, 3) and sr.max() > sr.min(),
                  f"test {extra} wrote a non-constant {4 * h}x{4 * w} image")
            check(launches == 5 * 3 * NUM_RRDB * batches,
                  f"test {extra}: rdb_fwd launches {launches}")
            rows.append({"args": extra, "wall_ms": wall_ms,
                         "rdb_fwd_launches": launches})
    finally:
        os.chdir(cwd)
    say("test", image=list(TEST_IMAGE), runs=rows)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    phase_probe()
    # f32 references in full f32: cuDNN convolutions default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    rows = phase_rdb(args.seed)
    gen = phase_generator(args.seed, rows["bfloat16"]["ms"])
    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    ckpt = os.path.join(workdir, "esrgan-gan-best.pth")
    save_checkpoint(ckpt, 1, "gan", gen.state_dict())
    launches = phase_serve(gen, ckpt, args.seed)
    phase_test(ckpt, args.seed)
    bf16 = rows["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "rdb_fwd",
        "route": "cuda",
        "source": "torchsr_tpu_torch/ops/csrc/rdb_fwd.cu",
        "replaces": "torchsr_tpu/ops/pallas/rdb.py:142",
        "launches": launches,
        "max_abs_err": bf16["max_abs_err"],
        "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"],
        "library_ms": None,
        "dtype": "bfloat16",
        "shape": list(SERVE_RDB_SHAPE),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
