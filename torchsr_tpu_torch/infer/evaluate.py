"""The ``eval`` subcommand: score a trained generator on HR images.

The port of ``torchsr_tpu/infer/evaluate.py``, the standard SR
benchmark protocol against any directory of HR images:

    HR  ->  LR via the training pipeline's synthesis (PIL-parity
            quantized bicubic 1/4x, ``ops.resize.bicubic_resize``)
        ->  SR = generator(LR)          (whole-image or ``--tile``d)
        ->  per-image PSNR + SSIM vs HR

with the naive bicubic 4x re-upscale scored beside it.  Two PSNR
aggregates are reported: the mean of per-image PSNRs and the
reference's batch formula ``10 log10(1 / mean MSE)`` over the pixels of
every image.  Images whose sides are not multiples of the scale are
cropped (top-left) to the nearest multiple; images below the 11 x 11
SSIM window, or below ``--crop``, are skipped.

Scoring is metric-grade f32 by default, as in JAX: for its duration
``run_eval`` turns off TF32 in cuDNN's convolutions and in CUDA
matmuls (PyTorch's default lets cuDNN use TF32) and restores the
caller's settings after.  ``--bf16`` scores the serving compute dtype
instead.  ``--artifact`` scores a serving artifact (``infer/serving.py``)
instead of a checkpoint: the exact program a serving fleet runs, its
frames through ``ServedGenerator.upscale_image``.  ``image_dir`` may
be a ``.tsrpack`` archive (``data/packed.py``): its entries are the
directory's images in the directory's order, under the same names, so
the report is the directory's.  With ``--tile`` on CUDA each tile batch
replays the generator's captured graph.
"""

from __future__ import annotations

import contextlib
import json
import os
from argparse import Namespace

import numpy as np
import torch

from torchsr_tpu_torch.infer.runner import (
    load_trained_generator,
    resolve_device,
)
from torchsr_tpu_torch.infer.tiled import tile_forward, upscale_image
from torchsr_tpu_torch.ops.resize import bicubic_resize
from torchsr_tpu_torch.train.metrics import mse_per_sample, ssim_per_sample
from torchsr_tpu_torch.utils import image_io


@contextlib.contextmanager
def tf32_allowed(allow: bool):
    """Set cuDNN's and CUDA matmul's TF32 switches for the block and
    restore the caller's after."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def _center_crop(arr: np.ndarray, size: int) -> np.ndarray:
    h, w = arr.shape[:2]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return arr[top:top + size, left:left + size]


def _score_pair(sr: torch.Tensor, hr: torch.Tensor
                ) -> tuple[float, float, float]:
    """(PSNR dB, SSIM, MSE) of one SR image against its HR ground truth
    (HWC f32 tensors on one device)."""
    mse = float(mse_per_sample(sr[None], hr[None])[0])
    p = float(10.0 * np.log10(1.0 / max(mse, 1e-12)))
    s = float(ssim_per_sample(sr[None], hr[None])[0])
    return p, s, mse


def run_eval(args: Namespace, generator_cls, *,
             allow_tf32: bool = False,
             lr_operands: torch.dtype | None = None) -> dict:
    """Evaluate ``args.image_dir`` and return the report dict.

    ``allow_tf32`` lets cuDNN and CUDA matmuls use TF32 during the run
    (PyTorch's cuDNN default); it exists to measure what TF32 moves in
    a report, and the ``eval`` subcommand leaves it off.
    ``lr_operands=torch.bfloat16`` synthesizes the LR images and the
    bicubic baseline with each resampling product's operands rounded to
    bf16 (``bicubic_resize(operands=)``), as the JAX package's round-5
    reports were: a yardstick for comparing with them, library-only."""
    from torchsr_tpu_torch.data.loader import dataset_source

    device = resolve_device(getattr(args, "device", "cuda"))
    paths, reader = dataset_source(args.image_dir)
    if not paths:
        raise ValueError(
            f"no supported images found in directory {args.image_dir}"
        )
    with tf32_allowed(allow_tf32):
        return _run_eval(args, generator_cls, device, paths,
                         reader or image_io.load_image, lr_operands)


def _upscaler(args, generator_cls, device):
    """(scale, upscale(lr float HWC on the host) -> SR float HWC on the
    host) of the artifact or the checkpoint ``args`` names."""
    artifact = getattr(args, "artifact", None)
    if artifact:
        from torchsr_tpu_torch.infer.serving import ServedGenerator

        served = ServedGenerator(artifact, device=device)

        def upscale(lr: np.ndarray) -> np.ndarray:
            return served.upscale_image(
                lr, overlap=getattr(args, "tile_overlap", 16))

        return served.scale or 4, upscale
    # f32 by default (metric-grade); --bf16 scores the serving dtype
    generator = load_trained_generator(
        args, generator_cls, device=device,
        compute_dtype=(torch.bfloat16 if getattr(args, "bf16", False)
                       else torch.float32),
    )
    forward = tile_forward(generator, device)

    def upscale(lr: np.ndarray) -> np.ndarray:
        return upscale_image(
            forward, lr, scale=generator.scale_factor,
            tile=getattr(args, "tile", 0) or 0,
            overlap=getattr(args, "tile_overlap", 16),
            tile_batch=getattr(args, "tile_batch", 8), device=device,
        )

    return generator.scale_factor, upscale


def _run_eval(args, generator_cls, device, paths, read_image,
              lr_operands) -> dict:
    scale, upscale = _upscaler(args, generator_cls, device)
    crop = getattr(args, "crop", 0) or 0
    per_image = []
    mse_px_sum = 0.0  # sum of per-image MSE * pixel count
    px_sum = 0
    for path in paths:
        hr_u8 = read_image(path)
        if crop:
            if min(hr_u8.shape[:2]) < crop:
                print(f"skipping {path}: smaller than --crop {crop}")
                continue
            hr_u8 = _center_crop(hr_u8, crop)
        h = hr_u8.shape[0] // scale * scale
        w = hr_u8.shape[1] // scale * scale
        if h < 11 or w < 11:
            # below the 11x11 SSIM window
            print(f"skipping {path}: smaller than the SSIM window")
            continue
        hr = torch.from_numpy(
            hr_u8[:h, :w].astype(np.float32) / 255.0).to(device)

        # the training pipeline's LR synthesis: quantized PIL-parity
        # bicubic, so eval measures the distribution trained on
        lr = bicubic_resize(hr[None], (h // scale, w // scale),
                            quantize=True, operands=lr_operands)[0]
        sr = upscale(lr.cpu().numpy())
        bic = bicubic_resize(lr[None], (h, w), quantize=True,
                             operands=lr_operands)[0]

        p, s, mse = _score_pair(torch.from_numpy(sr).to(device), hr)
        bp, bs, _ = _score_pair(bic, hr)
        mse_px_sum += mse * h * w
        px_sum += h * w
        per_image.append({
            "image": os.path.basename(path), "hw": [h, w],
            "psnr": round(p, 4), "ssim": round(s, 5),
            "bicubic_psnr": round(bp, 4), "bicubic_ssim": round(bs, 5),
        })
        print(
            f"{os.path.basename(path)} ({h}x{w}): "
            f"PSNR {p:.2f} dB  SSIM {s:.4f}  "
            f"(bicubic {bp:.2f} dB / {bs:.4f})"
        )
        if getattr(args, "save_sr", False):
            image_io.save_image(sr, f"upres-{os.path.basename(path)}")

    if not per_image:
        raise ValueError("no image in the directory was evaluable")

    n = len(per_image)
    report = {
        "model": args.model.lower(),
        "images": n,
        "mean_psnr": round(sum(r["psnr"] for r in per_image) / n, 4),
        "mean_ssim": round(sum(r["ssim"] for r in per_image) / n, 5),
        # one log10 over the MSE pooled across every pixel (per-image
        # MSEs weighted by their pixel counts)
        "batch_psnr": round(
            float(10.0 * np.log10(
                1.0 / max(mse_px_sum / max(px_sum, 1), 1e-12)
            )), 4
        ),
        "mean_bicubic_psnr": round(
            sum(r["bicubic_psnr"] for r in per_image) / n, 4
        ),
        "mean_bicubic_ssim": round(
            sum(r["bicubic_ssim"] for r in per_image) / n, 5
        ),
        "per_image": per_image,
    }
    # SR-vs-bicubic margins (positive = the model beats the baseline)
    report["psnr_margin_db"] = round(
        report["mean_psnr"] - report["mean_bicubic_psnr"], 4
    )
    report["ssim_margin"] = round(
        report["mean_ssim"] - report["mean_bicubic_ssim"], 5
    )
    report["images_beating_bicubic_psnr"] = sum(
        1 for r in per_image if r["psnr"] > r["bicubic_psnr"]
    )
    print(
        f"\n{n} images: mean PSNR {report['mean_psnr']:.2f} dB  "
        f"mean SSIM {report['mean_ssim']:.4f}  "
        f"(batch PSNR {report['batch_psnr']:.2f} dB; bicubic baseline "
        f"{report['mean_bicubic_psnr']:.2f} dB / "
        f"{report['mean_bicubic_ssim']:.4f}; margin "
        f"{report['psnr_margin_db']:+.2f} dB / "
        f"{report['ssim_margin']:+.4f}; "
        f"{report['images_beating_bicubic_psnr']}/{n} images beat "
        f"bicubic PSNR)"
    )
    report_path = getattr(args, "report", None)
    if report_path:
        with open(report_path, "w") as fh:
            json.dump(report, fh, indent=2)
        print(f"Wrote report to {report_path}")
    return report
