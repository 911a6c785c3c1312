"""CLI: ``python -m torchsr_tpu_torch train|test|serve``.

The ported subcommands keep the JAX CLI's flag names and defaults, plus
``--device`` (default ``cuda``: the port runs on the card unless asked
for the CPU, and raises when CUDA is absent).  Subcommands and flags
that are not ported yet are not registered (ROADMAP.md, queue A).
"""

from __future__ import annotations

import os
from argparse import ArgumentParser, ArgumentTypeError, Namespace

from torchsr_tpu_torch.__version__ import VERSION
from torchsr_tpu_torch.constants import (
    BATCH_SIZE,
    EPOCHS,
    MODEL,
    PRE_EPOCHS,
    TRAIN_DIR,
)
from torchsr_tpu_torch.registry import MODEL_NAMES, select_test_model


def positive_integer(value: str) -> int:
    """Argparse type: strictly positive int."""
    try:
        int_value = int(value)
    except (TypeError, ValueError):
        raise ArgumentTypeError(f"invalid int value: '{value}'")
    if int_value < 1:
        raise ArgumentTypeError("value must be a positive integer!")
    return int_value


def nonnegative_integer(value: str) -> int:
    """Argparse type: int >= 0 (tile sizes/overlaps, where 0 disables)."""
    try:
        int_value = int(value)
    except (TypeError, ValueError):
        raise ArgumentTypeError(f"invalid int value: '{value}'")
    if int_value < 0:
        raise ArgumentTypeError("value must be a non-negative integer!")
    return int_value


def _add_device(parser: ArgumentParser) -> None:
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="Torch device to run on (default: cuda; the command fails "
             "when no CUDA device is present). Pass cpu to run on the "
             "CPU with the kernels' plain PyTorch versions.",
    )


def parse_args(argv: list[str] | None = None) -> Namespace:
    parser = ArgumentParser(f"torchSR-TPU (PyTorch/CUDA) Version: {VERSION}")
    commands = parser.add_subparsers(
        dest="function", metavar="function", required=True
    )

    train = commands.add_parser(
        "train", help="Train a super-resolution model against an HD "
                      "dataset: L1 pretrain, then the GAN phase.",
    )
    train.add_argument(
        "--train-dir", type=str, default=TRAIN_DIR,
        help=f"Directory where training images are stored (90/10 "
             f"train/eval split by --seed). Default: {TRAIN_DIR}.",
    )
    train.add_argument(
        "--batch-size", type=positive_integer, default=BATCH_SIZE,
        help=f"The number of images to include in every batch. "
             f"Default: {BATCH_SIZE}.",
    )
    train.add_argument(
        "--epochs", type=int, default=EPOCHS,
        help=f"The number of epochs to run training for. "
             f"Default: {EPOCHS}.",
    )
    train.add_argument(
        "--pretrain-epochs", type=int, default=PRE_EPOCHS,
        help=f"The number of epochs to run pretraining for. "
             f"Default: {PRE_EPOCHS}.",
    )
    train.add_argument(
        "--model", type=str, default=MODEL, choices=MODEL_NAMES,
        help="Select the model to use for super resolution.",
    )
    train.add_argument(
        "--crop-size", type=positive_integer,
        help="Override the HR training crop size (default: 128 for "
             "ESRGAN, the reference registry's).",
    )
    train.add_argument(
        "--gen-blocks", type=positive_integer, dest="num_residual",
        help="Override the generator's RRDB count (default 23); smaller "
             "= faster/smaller models.",
    )
    train.add_argument(
        "--vgg-convs", type=positive_integer,
        help="Truncate the perceptual-loss VGG19 trunk to the first N "
             "convolutions (default: the full 16-conv relu5_4 trunk).",
    )
    train.add_argument(
        "--vgg-weights", type=str,
        help="Path to a torchvision VGG19 .pth (or the JAX package's "
             "converted .ckpt) for the perceptual loss. Without it, "
             "weights are auto-discovered from TORCHSR_VGG_WEIGHTS, "
             "~/.cache/torchsr_tpu/ or the torch hub cache; if none "
             "exist a seeded random-feature VGG is used (with a loud "
             "warning).",
    )
    train.add_argument(
        "--disable-amp", action="store_true",
        help="Train in float32 (default: bfloat16 compute with f32 "
             "parameters on CUDA, float32 on the CPU).",
    )
    train.add_argument(
        "--seed", type=int, default=0,
        help="Seed of the data split, crops, flips and the seeded "
             "initialization of every network.",
    )
    train.add_argument(
        "--skip-image-save", action="store_true",
        help="Skip generating and saving the per-epoch sample image.",
    )
    train.add_argument(
        "--psnr-checkpoint", type=str,
        help="Existing trained model for the PSNR-based training phase.",
    )
    train.add_argument(
        "--gan-checkpoint", type=str,
        help="Existing trained model for the GAN-based training phase.",
    )
    train.add_argument(
        "--metrics-file", type=str, default=None,
        help="Append every logged metric dict (per-step train-loss, "
             "per-epoch PSNR/SSIM/val-loss/throughput/LRs) as one JSON "
             "line to this file.",
    )
    _add_device(train)

    test = commands.add_parser(
        "test",
        help="Generate a super resolution image based on a trained "
             "model.",
    )
    test.add_argument(
        "image", type=str,
        help="Filename of image to upres — or a directory: every "
             "supported image in it is upscaled to upres-{name}, "
             "reusing one loaded generator.",
    )
    test.add_argument(
        "--model", type=str, default=MODEL, choices=MODEL_NAMES,
        help="Select the model to use for super resolution.",
    )
    test.add_argument(
        "--seed", type=int, default=0,
        help="Unused at inference; accepted for CLI compatibility.",
    )
    test.add_argument(
        "--checkpoint", type=str,
        help="Explicit checkpoint path (.ckpt or reference .pth); "
             "defaults to {model}-gan-best in the working directory.",
    )
    test.add_argument(
        "--tile", type=nonnegative_integer, default=0,
        help="Tile size for tiled overlap-blend inference (0 = one "
             "whole-image forward like the reference).",
    )
    test.add_argument(
        "--tile-overlap", type=nonnegative_integer, default=16,
        help="Halo overlap between inference tiles, in LR pixels.",
    )
    test.add_argument(
        "--tile-batch", type=positive_integer, default=8,
        help="Tiles per generator forward during tiled inference.",
    )
    test.add_argument(
        "--disable-amp", action="store_true",
        help="Run the generator forward in float32 (default: bfloat16 "
             "on CUDA, float32 on the CPU).",
    )
    _add_device(test)

    serve = commands.add_parser(
        "serve",
        help="Run an HTTP serving daemon around a trained checkpoint: "
             "POST /upscale (image in, 4x PNG out, any frame size via "
             "tiling), GET /healthz (readiness-gated), GET /metadata, "
             "GET /metrics.",
    )
    serve.add_argument(
        "--host", type=str, default="127.0.0.1",
        help="Bind address (0.0.0.0 to accept fleet traffic).",
    )
    serve.add_argument(
        "--port", type=int, default=8765,
        help="Bind port (0 = ephemeral, printed at startup).",
    )
    serve.add_argument(
        "--tile-overlap", type=nonnegative_integer, default=0,
        help="Halo overlap in LR pixels for frames that tile (0 = the "
             "serving default).",
    )
    serve.add_argument(
        "--model", type=str, default=MODEL, choices=MODEL_NAMES,
        help="Model architecture of the checkpoint.",
    )
    serve.add_argument(
        "--checkpoint", type=str,
        help="Explicit checkpoint path (.ckpt or reference .pth); "
             "defaults to {model}-gan-best in the working directory.",
    )
    serve.add_argument(
        "--tile", type=nonnegative_integer, default=0,
        help="Serving tile size (0 = the per-model default: 64 for "
             "ESRGAN).",
    )
    serve.add_argument(
        "--tile-batch", type=positive_integer, default=16,
        help="Tiles per generator forward.",
    )
    serve.add_argument(
        "--disable-amp", action="store_true",
        help="Serve in float32 (default bfloat16 on CUDA, float32 on "
             "the CPU).",
    )
    serve.add_argument(
        "--max-request-mb", type=float, default=64,
        help="Reject request bodies larger than this before reading "
             "them (HTTP 413). 0 disables the limit.",
    )
    serve.add_argument(
        "--max-pending", type=int, default=8,
        help="Shed load (HTTP 503 + Retry-After) beyond this many "
             "in-flight upscales. 0 = unbounded queueing.",
    )
    serve.add_argument(
        "--max-input-mp", type=float, default=32,
        help="Reject decoded inputs larger than this many megapixels "
             "(HTTP 413). 0 disables the limit.",
    )
    _add_device(serve)

    args = parser.parse_args(argv)
    tile = getattr(args, "tile", 0)
    if tile and getattr(args, "tile_overlap", 0) >= tile:
        parser.error(
            f"--tile-overlap ({args.tile_overlap}) must be smaller "
            f"than --tile ({tile}): the tiling stride is their "
            f"difference and must stay positive"
        )
    return args


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    if args.function == "train":
        from torchsr_tpu_torch.train.trainer import run_train

        run_train(args)
    elif args.function == "test":
        from torchsr_tpu_torch.infer.runner import run_test

        out = run_test(args, select_test_model(args))
        if os.path.isdir(args.image):
            print(f"Saved super-resolution images: {out}")
        else:
            print(f"Saved super-resolution image to {out}")
    elif args.function == "serve":
        from torchsr_tpu_torch.infer.server import run_server

        run_server(args)


if __name__ == "__main__":
    main()
