"""The JAX package's ``bench.py`` on the port: five metrics from one card.

    python -m torchsr_tpu_torch.tools.bench [--device cuda]

Prints ``bench.py``'s five JSON lines, in its order and under its metric
names, each with the card's name and power limit (``device``,
``power_limit_w``, from ``nvidia-smi``):

1. ``esrgan_gan_step_crops_per_sec_per_chip``: the ESRGAN GAN step
   (batch 64, crop 128, 16 steps);
2. ``srgan_gan_step_crops_per_sec_per_chip``: the SRGAN GAN step (batch
   128, crop 96, 16 steps);
3. ``esrgan_tiled_infer_output_mp_per_sec``: ESRGAN tiled 1080p -> 4K
   (tile 64, overlap 8, tile batch 16), 4K output megapixels a second;
4. ``srgan_tiled_infer_output_mp_per_sec``: SRGAN likewise (tile 256,
   overlap 16, tile batch 8);
5. last, the headline ``srgan_train_crops_per_sec_per_chip``: the SRGAN
   pretrain step with pair synthesis inside it (batch 128, crop 96, 5
   warm-up and 60 measured steps).

The protocol is bench.py's: synthetic loaders (``data/synthetic.py``),
the trainer's production multi-step programs (``gan_step_multi``,
``pretrain_step_multi``: K steps a call as replays of a CUDA-graph
captured step, K the trainer's default) fed distinct stacked batch
groups in turn, chains of calls that end in a scalar read back to the
host, and two measured phases of which the second is kept.  Training
runs in bf16 with f32 parameters and random seeded weights (random VGG
features); tiled inference runs the bf16 generator through
``infer/tiled.py`` ``tiled_upscale``, eagerly.

``vs_baseline`` divides by bench.py's estimated V100 throughputs for the
same work (its constants, kept as they are): published V100 estimates,
not TPU numbers.  A metric that fails is reported on stderr and the
others still print; the run then exits non-zero.  The sizes are the
functions' arguments, so that each metric can run tiny on the CPU
(``device="cpu"``: f32, no kernel; its numbers are not the card's).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from argparse import Namespace

import numpy as np
import torch

# bench.py's V100 estimates (see its docstring): SRGAN pretrain ~500
# crops/s, ESRGAN GAN ~40, SRGAN GAN ~150, SRGAN tiled 1080p->4K ~20 4K
# output MP/s; ESRGAN tiled ~2 MP/s (the SRGAN estimate scaled by the
# ESRGAN/SRGAN FLOP ratio).
V100_BASELINE_CROPS_PER_SEC = 500.0
V100_ESRGAN_GAN_CROPS_PER_SEC = 40.0
V100_SRGAN_GAN_CROPS_PER_SEC = 150.0
V100_SRGAN_INFER_OUT_MP_PER_SEC = 20.0
V100_ESRGAN_INFER_OUT_MP_PER_SEC = 2.0

BATCH = 128
CROP = 96
WARMUP_STEPS = 5
MEASURE_STEPS = 60
SRGAN_GAN_STEPS = 16
ESRGAN_BATCH = 64
ESRGAN_CROP = 128
ESRGAN_STEPS = 16
FRAME_HW = (1080, 1920)


def card(device: torch.device | str) -> dict:
    """The card's name and power limit (W) as ``nvidia-smi`` gives them;
    on the CPU the device name and no limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": str(device), "power_limit_w": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    name, limit = out[device.index or 0].rsplit(",", 1)
    return {"device": name.strip(), "power_limit_w": float(limit)}


def _line(metric: str, value: float, unit: str, vs_baseline: float,
          device: torch.device) -> dict:
    row = {"metric": metric, "value": round(value, 2), "unit": unit,
           "vs_baseline": round(vs_baseline, 3), **card(device)}
    print(json.dumps(row), flush=True)
    return row


def make_trainer(model: str, batch: int, crop: int, device, *,
                 n_batches: int = 2, num_residual: int | None = None,
                 vgg_convs: int | None = None):
    """A ``model`` trainer on synthetic loaders (seed 0), on ``device``
    (resolved: CUDA must be present unless the CPU is asked for)."""
    from torchsr_tpu_torch.data.synthetic import (
        SyntheticEvalLoader,
        SyntheticTrainLoader,
    )
    from torchsr_tpu_torch.infer.runner import resolve_device
    from torchsr_tpu_torch.train.trainer import ESRGANTrainer, SRGANTrainer
    from torchsr_tpu_torch.utils.logging import Logger

    os.environ["WANDB_MODE"] = "disabled"  # a bench is never a sink
    args = Namespace(
        batch_size=batch, disable_amp=False, epochs=1, pretrain_epochs=1,
        gan_checkpoint=None, psnr_checkpoint=None, seed=0,
        skip_image_save=True, model=model, num_residual=num_residual,
        vgg_convs=vgg_convs, metrics_file=None, vgg_weights=None)
    tl = SyntheticTrainLoader(batch, crop, n_batches=n_batches)
    el = SyntheticEvalLoader(batch, crop, n_batches=1)
    cls = ESRGANTrainer if model == "esrgan" else SRGANTrainer
    return cls(args, tl, el, tl.dataset_len, el.dataset_len,
               device=resolve_device(device), logger=Logger())


def stacked_device_batches(trainer, k: int, n_stacks: int = 2) -> list:
    """Distinct (k, batch, ...) device batch stacks of the trainer's
    loader, cycled during timing so that successive calls see other
    data (bench.py's ``_stacked_device_batches``)."""
    host = [tuple(b) for b in trainer.train_loader.epoch(0)]
    stacks = []
    for s in range(n_stacks):
        group = [host[(s * k + i) % len(host)] for i in range(k)]
        stacks.append(tuple(
            torch.from_numpy(np.stack([g[j] for g in group])).to(
                trainer.device) for j in range(len(group[0]))))
    return stacks


def _dtype_name(trainer) -> str:
    return str(trainer.compute_dtype).removeprefix("torch.")


def _gan_crops_per_sec(trainer, steps: int) -> float:
    """Chained ``gan_step_multi`` calls (K the trainer's GAN default) on
    cycled stacks, ending in a scalar readback; two measured phases,
    the second kept.  Returns crops/s."""
    k = trainer.gan_steps_per_call
    stacks = stacked_device_batches(trainer, k)

    def one_call(crops_k, flips_k):
        return trainer.gan_step_multi(crops_k, flips_k, 1e-4,
                                      1e-4)["gen_loss"][-1]

    float(one_call(*stacks[0]))  # warm-up (and capture) completed
    calls = max(steps // k, 1)
    for _phase in range(2):
        start = time.perf_counter()
        for i in range(calls):
            gl = one_call(*stacks[i % len(stacks)])
        float(gl)  # the chain's completion
        elapsed = time.perf_counter() - start
    return trainer.batch_size * calls * k / elapsed


def bench_esrgan_gan(batch: int = ESRGAN_BATCH, crop: int = ESRGAN_CROP,
                     steps: int = ESRGAN_STEPS, *, device="cuda",
                     num_residual: int | None = None,
                     vgg_convs: int | None = None) -> dict:
    """The ESRGAN full adversarial step (the reference's default
    training mode): one generator forward on the RDB kernels, the
    discriminator's update, the VGG19-perceptual generator update,
    three Adam states; K = 2 steps a call."""
    trainer = make_trainer("esrgan", batch, crop, device,
                           num_residual=num_residual, vgg_convs=vgg_convs)
    value = _gan_crops_per_sec(trainer, steps)
    return _line(
        "esrgan_gan_step_crops_per_sec_per_chip", value,
        f"crops/sec/chip (ESRGAN full GAN step, {crop}x{crop} HR, batch "
        f"{batch}, {_dtype_name(trainer)}, Hopper RDB kernels, "
        f"{trainer.gan_steps_per_call} replayed steps a call)",
        value / V100_ESRGAN_GAN_CROPS_PER_SEC, trainer.device)


def bench_srgan_gan(batch: int = BATCH, crop: int = CROP,
                    steps: int = SRGAN_GAN_STEPS, *, device="cuda",
                    num_residual: int | None = None,
                    vgg_convs: int | None = None) -> dict:
    """The SRGAN full adversarial step at batch 128: generator forward,
    discriminator update (two forwards), VGG19-perceptual generator
    update, three Adam states; K = 8 steps a call."""
    trainer = make_trainer("srgan", batch, crop, device,
                           num_residual=num_residual, vgg_convs=vgg_convs)
    value = _gan_crops_per_sec(trainer, steps)
    return _line(
        "srgan_gan_step_crops_per_sec_per_chip", value,
        f"crops/sec/chip (SRGAN full GAN step, {crop}x{crop} HR, batch "
        f"{batch}, {_dtype_name(trainer)}, {trainer.gan_steps_per_call} "
        f"replayed steps a call)",
        value / V100_SRGAN_GAN_CROPS_PER_SEC, trainer.device)


def _tiled_mp_per_sec(gen, frame_hw, tile, overlap, tile_batch, frames,
                      device) -> float:
    """4K output MP/s of ``tiled_upscale`` on a seeded random frame:
    one warm-up frame read back, then two measured phases of
    ``frames`` frames each ending in a readback, the second kept."""
    from torchsr_tpu_torch.infer.tiled import tiled_upscale

    h, w = frame_hw
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(
        rng.random((h, w, 3)).astype(np.float32)).to(device)

    def run():
        return tiled_upscale(gen, frame, scale=4, tile=tile,
                             overlap=overlap, tile_batch=tile_batch)

    out = run()
    float(out.mean())  # warm-up completed
    if tuple(out.shape) != (4 * h, 4 * w, 3):
        raise RuntimeError(f"tiled output {tuple(out.shape)} is not 4x "
                           f"{frame_hw}")
    for _phase in range(2):
        start = time.perf_counter()
        for _ in range(frames):
            out = run()
        float(out.mean())
        elapsed = time.perf_counter() - start
    return 16 * h * w / 1e6 / (elapsed / frames)


def _generator(model: str, device, num_residual: int | None):
    """The model's generator, seeded random weights, for inference in
    the serving dtype (bf16 on CUDA, f32 on the CPU)."""
    from torchsr_tpu_torch.infer.runner import (
        resolve_compute_dtype,
        resolve_device,
    )
    from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
    from torchsr_tpu_torch.models.srgan import SRGANGenerator

    device = resolve_device(device)
    seeded = torch.Generator().manual_seed(0)
    if model == "esrgan":
        gen = ESRGANGenerator(num_rrdb_blocks=num_residual or 23,
                              generator=seeded)
    else:
        gen = SRGANGenerator(num_residual=num_residual or 16,
                             generator=seeded)
    gen = gen.to(device).eval().requires_grad_(False)
    gen.compute_dtype = resolve_compute_dtype(Namespace(), device)
    return gen, device


def bench_esrgan_tiled_inference(frame_hw=FRAME_HW, tile: int = 64,
                                 overlap: int = 8, tile_batch: int = 16,
                                 frames: int = 2, *, device="cuda",
                                 num_residual: int | None = None) -> dict:
    """ESRGAN (the reference's default model) tiled 4x inference, 1080p
    -> 4K, tile 64 / overlap 8 / tile batch 16 (bench.py's: 64-pixel
    tiles keep the RDB kernel on its serving shape)."""
    gen, device = _generator("esrgan", device, num_residual)
    value = _tiled_mp_per_sec(gen, frame_hw, tile, overlap, tile_batch,
                              frames, device)
    dtype = str(gen.compute_dtype).removeprefix("torch.")
    return _line(
        "esrgan_tiled_infer_output_mp_per_sec", value,
        f"4K-output MP/sec (ESRGAN tiled {frame_hw[0]}p->4x, tile {tile}, "
        f"overlap {overlap}, tile-batch {tile_batch}, {dtype}, Hopper RDB "
        f"kernels)", value / V100_ESRGAN_INFER_OUT_MP_PER_SEC, device)


def bench_tiled_inference(frame_hw=FRAME_HW, tile: int = 256,
                          overlap: int = 16, tile_batch: int = 8,
                          frames: int = 3, *, device="cuda",
                          num_residual: int | None = None) -> dict:
    """SRGAN tiled 4x inference, 1080p -> 4K, tile 256 / overlap 16 /
    tile batch 8 (bench.py's round-5 choice)."""
    gen, device = _generator("srgan", device, num_residual)
    value = _tiled_mp_per_sec(gen, frame_hw, tile, overlap, tile_batch,
                              frames, device)
    dtype = str(gen.compute_dtype).removeprefix("torch.")
    return _line(
        "srgan_tiled_infer_output_mp_per_sec", value,
        f"4K-output MP/sec (SRGAN tiled {frame_hw[0]}p->4x, tile {tile}, "
        f"overlap {overlap}, tile-batch {tile_batch}, {dtype})",
        value / V100_SRGAN_INFER_OUT_MP_PER_SEC, device)


def bench_srgan_train(batch: int = BATCH, crop: int = CROP,
                      warmup_steps: int = WARMUP_STEPS,
                      measure_steps: int = MEASURE_STEPS, *, device="cuda",
                      num_residual: int | None = None) -> dict:
    """The headline: the SRGAN pretrain step (generator forward and
    backward, Adam) with the LR/HR pair synthesis inside it, fed from
    host-RAM uint8 crops, K = 8 steps a call; chained calls whose
    summed losses are read back once."""
    trainer = make_trainer("srgan", batch, crop, device, n_batches=4,
                           num_residual=num_residual)
    k = trainer.steps_per_call
    stacks = stacked_device_batches(trainer, k)
    for i in range(max(warmup_steps // k, 1)):
        losses = trainer.pretrain_step_multi(*stacks[i % len(stacks)])
    float(losses[-1])  # the warm-up (and capture) completed
    calls = max(measure_steps // k, 1)
    measured = calls * k
    for _phase in range(2):
        start = time.perf_counter()
        total = None
        for i in range(calls):
            loss = trainer.pretrain_step_multi(*stacks[i % len(stacks)]).sum()
            total = loss if total is None else total + loss
        final = float(total)  # the whole chain's completion
        elapsed = time.perf_counter() - start
    per_step = elapsed / measured
    print(f"bench: {measured} chained steps x {batch} crops in "
          f"{elapsed:.3f}s -> {per_step * 1e3:.2f} ms/step on "
          f"{trainer.device}; mean loss={final / measured:.5f}",
          file=sys.stderr)
    value = batch / per_step
    return _line(
        "srgan_train_crops_per_sec_per_chip", value,
        f"crops/sec/chip ({crop}x{crop} HR, batch {batch}, "
        f"{_dtype_name(trainer)}, {k} replayed steps a call)",
        value / V100_BASELINE_CROPS_PER_SEC, trainer.device)


def main(argv=None) -> int:
    """Every metric in bench.py's order, the headline last; returns 1
    (after the others printed) when any failed."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) "
                             "or cpu")
    args = parser.parse_args(argv)
    failed = []
    for bench in (bench_esrgan_gan, bench_srgan_gan,
                  bench_esrgan_tiled_inference, bench_tiled_inference,
                  bench_srgan_train):
        try:
            bench(device=args.device)
        except Exception:  # the next metric still runs; the exit shows it
            traceback.print_exc()
            failed.append(getattr(bench, "__name__", str(bench)))
        gc.collect()
        if torch.device(args.device).type == "cuda":
            torch.cuda.empty_cache()  # the last trainer's graphs' pools
    if failed:
        print(f"bench: failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
