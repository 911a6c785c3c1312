"""CLI: ``python -m torchsr_tpu_torch train|test|serve|eval|interp|doctor``.

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
        "--eval-dir", type=str,
        help="Validate on ALL images in this directory instead of "
             "holding out 10%% of --train-dir; training then uses the "
             "full train directory.",
    )
    train.add_argument(
        "--dataset-multiplier", type=positive_integer, default=1,
        help="Artificially increase the dataset size by sampling N "
             "random crops per image per epoch (the eval set too).",
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
             "ESRGAN, 96 for SRGAN, the reference registry's).",
    )
    train.add_argument(
        "--gen-blocks", type=positive_integer, dest="num_residual",
        help="Override the generator's block count (default 23 RRDBs "
             "for ESRGAN, 16 residual blocks for SRGAN); smaller = "
             "faster/smaller models.",
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
    train.add_argument(
        "--steps-per-call", type=positive_integer, default=None,
        help="Training steps per host call: a call copies each batch of "
             "a stacked group of N into the step's captured CUDA graph "
             "and replays it (on the CPU it runs N eager steps); the "
             "epoch's ragged tail replays the same graph.  1 makes "
             "every batch its own call.  Default: 8 for the pretrain; "
             "for the GAN phase 8 for SRGAN, 2 for ESRGAN (the JAX "
             "package's measured optima).",
    )
    train.add_argument(
        "--profile-steps", type=int, default=0,
        help="Write a torch.profiler trace (CPU and CUDA activity, "
             "Chrome format) of N training steps, after the first two, "
             "to <profile-dir>/trace.json. 0 disables profiling.",
    )
    train.add_argument(
        "--profile-dir", type=str, default="traces",
        help="Output directory for profiler traces. Default: traces/.",
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
             "ESRGAN, 256 for SRGAN).",
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

    ev = commands.add_parser(
        "eval",
        help="Score a trained generator on a directory of HR images: "
             "the training pipeline's LR synthesis, per-image PSNR/SSIM "
             "against the ground truth, the naive-bicubic baseline "
             "beside it.",
    )
    ev.add_argument(
        "image_dir", type=str,
        help="Directory of HR ground-truth images to evaluate against.",
    )
    ev.add_argument(
        "--model", type=str, default=MODEL, choices=MODEL_NAMES,
        help="Model architecture of the checkpoint.",
    )
    ev.add_argument(
        "--checkpoint", type=str,
        help="Checkpoint path (.ckpt or reference .pth); defaults to "
             "{model}-gan-best in the working directory.",
    )
    ev.add_argument(
        "--crop", type=positive_integer, default=None,
        help="Center-crop HR images to NxN before scoring (smaller "
             "images are skipped). Default: full images, cropped to a "
             "multiple of the 4x scale.",
    )
    ev.add_argument(
        "--tile", type=nonnegative_integer, default=0,
        help="Tile size for tiled overlap-blend inference (0 = "
             "whole-image forward).",
    )
    ev.add_argument(
        "--tile-overlap", type=nonnegative_integer, default=16,
        help="Halo overlap between inference tiles, in LR pixels.",
    )
    ev.add_argument(
        "--tile-batch", type=positive_integer, default=8,
        help="Tiles per generator forward during tiled inference.",
    )
    ev.add_argument(
        "--bf16", action="store_true",
        help="Score with the bfloat16 serving forward instead of "
             "float32, to measure the serving precision's quality cost.",
    )
    ev.add_argument(
        "--save-sr", action="store_true",
        help="Also write each super-resolved image as upres-{name}.",
    )
    ev.add_argument(
        "--report", type=str,
        help="Write the full per-image report as JSON to this path.",
    )
    ev.add_argument(
        "--seed", type=int, default=0,
        help="Unused at evaluation; accepted for CLI compatibility.",
    )
    _add_device(ev)

    interp = commands.add_parser(
        "interp",
        help="Network interpolation (ESRGAN paper sec. 3.4): blend the "
             "PSNR-pretrained and GAN-finetuned generators into one "
             "checkpoint for a perception/distortion tradeoff.",
    )
    interp.add_argument(
        "psnr_checkpoint", type=str,
        help="PSNR-oriented checkpoint (.pth or .ckpt), e.g. "
             "{model}-psnr-best.pth.",
    )
    interp.add_argument(
        "gan_checkpoint", type=str,
        help="GAN-oriented checkpoint (.pth or .ckpt), e.g. "
             "{model}-gan-best.pth.",
    )
    interp.add_argument(
        "--alpha", type=float, default=0.8,
        help="Interpolation weight of the GAN model: (1-alpha)*psnr + "
             "alpha*gan. 0 = pure PSNR model, 1 = pure GAN model "
             "(default 0.8, the ESRGAN paper's recommendation).",
    )
    interp.add_argument(
        "--output", "-o", type=str, default=None,
        help="Output checkpoint path (default "
             "{model}-interp-{alpha}.pth).",
    )
    interp.add_argument(
        "--model", type=str, default=MODEL, choices=MODEL_NAMES,
        help="Model architecture of the checkpoints.",
    )

    doctor = commands.add_parser(
        "doctor",
        help="Diagnose the environment: torch/CUDA versions, the card, "
             "nvcc and the kernel libraries, the RDB kernel variant the "
             "knobs select, env knobs, checkpoints in the working "
             "directory, optional dataset and checkpoint checks.",
    )
    doctor.add_argument(
        "--train-dir", type=str, default=None,
        help="Also discover and split a dataset directory, reporting "
             "image counts.",
    )
    doctor.add_argument(
        "--checkpoint", type=str, default=None,
        help="Inspect a checkpoint file on the host: format, epoch and "
             "phase, parameter count, the block count and scale test "
             "and serve would use.",
    )
    doctor.add_argument(
        "--json", action="store_true",
        help="Emit the report as JSON instead of text.",
    )

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
    elif args.function == "eval":
        from torchsr_tpu_torch.infer.evaluate import run_eval

        run_eval(args, select_test_model(args))
    elif args.function == "interp":
        from torchsr_tpu_torch.utils.interp import interpolate_checkpoints

        output = args.output or (
            f"{args.model.lower()}-interp-{args.alpha:g}.pth")
        out = interpolate_checkpoints(args.psnr_checkpoint,
                                      args.gan_checkpoint, args.alpha,
                                      output, args.model)
        print(f"Saved interpolated checkpoint to {out}")
    elif args.function == "doctor":
        from torchsr_tpu_torch.utils.doctor import run_doctor

        run_doctor(args)


if __name__ == "__main__":
    main()
