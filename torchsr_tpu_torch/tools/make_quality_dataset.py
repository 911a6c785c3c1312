"""Build the quality corpus the round-5 runs train and score on.

The port's own copy of the JAX package's corpus script (numpy and
Pillow only), so that ``quality_run`` runs nothing outside the port; it
writes the same PNG files, byte for byte.

The repository ships one real photograph
(``media/waterfalls-low-res.png``, the reference's bundled progress
sample). This tool turns it into a reproducible train/eval corpus:

* **photo images** — 4x4 mosaics of square crops of the photo (by
  default 2x-LANCZOS-decimated, which concentrates its detail; a naive
  bicubic 4x re-upscale of the native pixels scores 42 dB, of the
  decimated ones 28 dB). Crops are never upsampled, and get dihedral
  transforms, channel permutations, and gamma/brightness jitter.
* **procedural images** — multi-octave value noise overlaid with
  hard-edged discs/bars, thin lines, pixel-scale checker patches, and
  film-grain noise.

Train and eval sets use disjoint seeds AND disjoint photo crop regions
(eval crops come from the right third of the photo, train from the
left two thirds), so eval measures generalization, not crop identity.

Usage:
    python -m torchsr_tpu_torch.tools.make_quality_dataset --out DIR
        [--photo-only] [--no-decimate]
    # -> DIR/train/*.png (200), DIR/eval/*.png (24)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PHOTO = os.path.join(REPO, "media", "waterfalls-low-res.png")
SIZE = 176  # fits ESRGAN's 128 crop and SRGAN's 96 with margin


def _jitter(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Photometric jitter in float [0,1]; no resampling."""
    img = img.astype(np.float32) / 255.0
    gamma = 0.7 + 0.6 * rng.random()
    gain = 0.8 + 0.4 * rng.random()
    img = np.clip(img**gamma * gain, 0.0, 1.0)
    if rng.random() < 0.5:
        img = img[..., rng.permutation(3)]
    return (img * 255.0 + 0.5).astype(np.uint8)


def _photo_crop(
    rng: np.random.Generator, photo: np.ndarray, x_range: tuple[int, int]
) -> np.ndarray:
    """A SIZE x SIZE mosaic of 4x4 tile crops of the decimated photo
    (``photo`` is already the 2x-LANCZOS-decimated image).  The mosaic
    keeps the canvas at production crop sizes without ever upsampling
    photo pixels; its seams are ordinary step edges.  ``x_range``
    bounds the tile x-positions so train/eval draw from disjoint photo
    regions."""
    h, w = photo.shape[:2]
    tile = SIZE // 4
    x0, x1 = x_range  # inclusive range of allowed tile START columns
    hi = max(x0 + 1, min(x1, w - tile) + 1)
    rows = []
    for _ in range(4):
        row = []
        for _ in range(4):
            y = int(rng.integers(0, h - tile + 1))
            x = int(rng.integers(x0, hi))
            t = photo[y : y + tile, x : x + tile]
            t = np.rot90(t, int(rng.integers(4)))
            if rng.random() < 0.5:
                t = t[:, ::-1]
            if rng.random() < 0.5:
                t = t[::-1]
            row.append(np.ascontiguousarray(t))
        rows.append(np.concatenate(row, axis=1))
    return _jitter(rng, np.concatenate(rows, axis=0))


def _value_noise(rng: np.random.Generator) -> np.ndarray:
    """Multi-octave smooth noise (the low-frequency bed)."""
    acc = np.zeros((SIZE, SIZE, 3), np.float32)
    amp, total = 1.0, 0.0
    for cells in (4, 8, 16, 32):
        grid = rng.random((cells + 1, cells + 1, 3)).astype(np.float32)
        img = np.asarray(
            Image.fromarray(
                (grid * 255).astype(np.uint8)
            ).resize((SIZE, SIZE), Image.BICUBIC),
            np.float32,
        ) / 255.0
        acc += amp * img
        total += amp
        amp *= 0.55
    return acc / total


def _procedural(rng: np.random.Generator) -> np.ndarray:
    """Low-frequency bed + hard-edged and pixel-scale detail.

    The detail layers are what keep the bicubic 4x re-upscale honest:
    step edges, thin lines, and fine checker/grain cannot be recovered
    from a 1/4-scale bicubic downsample."""
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    img = _value_noise(rng)

    # hard-edged discs and rotated bars (step edges)
    for _ in range(int(rng.integers(4, 9))):
        color = rng.random(3).astype(np.float32)
        if rng.random() < 0.5:
            cy, cx = rng.random(2) * SIZE
            r = 6 + rng.random() * 30
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        else:
            theta = rng.random() * np.pi
            c, s = np.cos(theta), np.sin(theta)
            d = c * (xx - SIZE / 2) + s * (yy - SIZE / 2)
            off = (rng.random() - 0.5) * SIZE
            thick = 1.5 + rng.random() * 8
            mask = np.abs(d - off) < thick
        a = 0.65 + 0.35 * rng.random()
        img[mask] = (1 - a) * img[mask] + a * color

    # pixel-scale checker patch (Nyquist-frequency texture)
    if rng.random() < 0.7:
        ph, pw = (rng.integers(24, 64), rng.integers(24, 64))
        py = int(rng.integers(0, SIZE - ph))
        px = int(rng.integers(0, SIZE - pw))
        cell = int(rng.integers(1, 4))
        checker = (
            ((yy[py:py + ph, px:px + pw] // cell)
             + (xx[py:py + ph, px:px + pw] // cell)) % 2
        ).astype(np.float32)
        tint = 0.25 + 0.75 * rng.random(3).astype(np.float32)
        img[py:py + ph, px:px + pw] = (
            0.45 * img[py:py + ph, px:px + pw]
            + 0.55 * checker[..., None] * tint
        )

    # film grain over the whole frame
    grain = rng.normal(0.0, 0.02 + 0.04 * rng.random(), img.shape)
    img = img + grain.astype(np.float32)
    return (np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8)


def build(
    out: str,
    n_train: int,
    n_eval: int,
    seed: int,
    photo_only: bool = False,
    decimate: bool = True,
) -> None:
    src = Image.open(PHOTO).convert("RGB")
    if decimate:
        photo = np.asarray(
            src.resize((src.width // 2, src.height // 2), Image.LANCZOS)
        )
    else:
        photo = np.asarray(src)
    w = photo.shape[1]
    tile = SIZE // 4
    # Disjoint photo regions: train tiles end before column split_at,
    # eval tiles start at or after it.
    split_at = (3 * w) // 5
    for split, n, sd, x_range in (
        ("train", n_train, seed, (0, split_at - tile)),
        ("eval", n_eval, seed + 1000, (split_at, w - tile)),
    ):
        rng = np.random.default_rng(sd)
        d = os.path.join(out, split)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            if photo_only or i % 2 == 0:
                img = _photo_crop(rng, photo, x_range)
            else:
                img = _procedural(rng)
            Image.fromarray(img).save(
                os.path.join(d, f"{split}_{i:03d}.png")
            )
        print(f"{split}: {n} images -> {d}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--n-train", type=int, default=200)
    parser.add_argument("--n-eval", type=int, default=24)
    parser.add_argument("--seed", type=int, default=4)
    parser.add_argument(
        "--photo-only",
        action="store_true",
        help="photo-mosaic images only (no procedural/grain images); the "
        "GAN-phase-stability evidence configuration — grain-free content "
        "keeps the discriminator from trivially separating SR from HR",
    )
    parser.add_argument(
        "--no-decimate",
        action="store_true",
        help="mosaic the photo's NATIVE pixels instead of the "
        "2x-LANCZOS-decimated ones.  The blurry native content makes "
        "bicubic re-upscaling nearly lossless (no margin to learn) — "
        "NOT for quality headlines — but its weak high-frequency "
        "signal is the most GAN-stable configuration (the round-4 "
        "run-1 GAN-holds-PSNR evidence setup).",
    )
    args = parser.parse_args(argv)
    if not os.path.exists(PHOTO):
        print(f"error: {PHOTO} missing", file=sys.stderr)
        return 1
    build(
        args.out, args.n_train, args.n_eval, args.seed,
        args.photo_only, not args.no_decimate,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
