"""CLI: ``python -m torchsr_tpu_torch
train|test|export|serve|eval|interp|pack|doctor``.

The ported subcommands keep the JAX CLI's flag names and defaults, plus
``--device`` (default ``cuda``: the port runs on the card unless asked
for the CPU, and raises when CUDA is absent; ``pack`` and ``doctor``
are host-only).  Multi-device runs: ``train`` under ``torchrun`` is
data-parallel (NCCL, one process a card; ``--master-addr``,
``--master-port``, ``--num-devices``), ``test --shard-tiles`` /
``serve --shard-tiles`` spread a frame's tile batches over the visible
cards, and ``test --spatial-shard`` splits an image into a grid of
blocks with halos over them.
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
             f"train/eval split by --seed), or a .tsrpack archive of it "
             f"(`pack`). Default: {TRAIN_DIR}.",
    )
    train.add_argument(
        "--eval-dir", type=str,
        help="Validate on ALL images in this directory (or .tsrpack) "
             "instead of holding out 10%% of --train-dir; training then "
             "uses the full train directory.",
    )
    train.add_argument(
        "--data-workers", type=positive_integer, default=16,
        help="Threads that decode and crop for each data loader.",
    )
    train.add_argument(
        "--shuffle-window", type=nonnegative_integer, default=0,
        help="Out-of-core shuffle: visit windows of N samples in random "
             "order (shuffled within each) instead of one global "
             "permutation, so a dataset larger than the decode cache is "
             "decoded once an epoch. 0 (default) = global shuffle.",
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
        "--master-addr", type=str,
        help="Address used for multi-host coordination (overrides "
             "MASTER_ADDR).",
    )
    train.add_argument(
        "--master-port", type=str,
        help="Port used for multi-host coordination (overrides "
             "MASTER_PORT).",
    )
    train.add_argument(
        "--num-devices", type=positive_integer,
        help="Limit the data-parallel mesh to the first N local devices: "
             "the number of torchrun processes (one card each), which "
             "must equal it.",
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
        "--sample-image", type=str,
        help="Override the per-epoch progress sample image path "
             "(default: media/waterfalls-low-res.png).",
    )
    train.add_argument(
        "--scale", type=int, default=4, choices=(2, 4, 8),
        dest="upscale_factor",
        help="Upscale factor: the generator's upsample stage count "
             "(log2(scale)) and the LR synthesis ratio; test, eval, "
             "export and serve read the scale from the checkpoint.",
    )
    train.add_argument(
        "--fast-compile", action="store_true",
        help="Kept for parity with the JAX CLI, whose flag shortens "
             "the XLA compile. The port has no long compile to shorten: "
             "it logs one line and trains as without the flag (the "
             "steps captured and replayed on CUDA).",
    )
    train.add_argument(
        "--sync-saves", action="store_true",
        help="Write checkpoints in the epoch loop instead of the default "
             "writer thread (which snapshots the state on the device and "
             "streams it to disk while training continues).",
    )
    train.add_argument(
        "--no-preempt-save", action="store_true",
        help="Install no SIGTERM handler (by default a termination "
             "signal saves the full training state as {phase}-latest at "
             "the next step boundary and exits cleanly).",
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
    test.add_argument(
        "--spatial-shard", action="store_true",
        help="Shard the image spatially over all devices: a grid of "
             "blocks, each run with an --tile-overlap halo of real "
             "neighbour pixels (see infer/halo.py). Uses --tile-overlap "
             "as the halo.",
    )
    test.add_argument(
        "--shard-tiles", action="store_true",
        help="Shard the tiled-inference tile batches over all devices "
             "(a generator replica a device, no collectives; see "
             "infer/multichip.py). Implies tiling: --tile defaults to "
             "the measured per-model serving tile when unset.",
    )
    _add_device(test)

    export = commands.add_parser(
        "export",
        help="Export a trained generator as a self-contained serving "
             "artifact: a torch.export program (.pt2) with the weights "
             "baked in, loadable without the model code, and a JSON "
             "sidecar (see infer/serving.py).",
    )
    export.add_argument(
        "output", type=str,
        help="Output artifact path (a JSON sidecar is written next to "
             "it).",
    )
    export.add_argument(
        "--model", type=str, default=MODEL, choices=MODEL_NAMES,
        help="Model architecture of the checkpoint.",
    )
    export.add_argument(
        "--checkpoint", type=str,
        help="Checkpoint path (.ckpt or reference .pth); defaults to "
             "{model}-gan-best in the working directory.",
    )
    export.add_argument(
        "--tile", type=positive_integer, default=64,
        help="Input tile size baked into the artifact (serving runs "
             "fixed shapes; larger frames tile through it).",
    )
    export.add_argument(
        "--tile-batch", type=positive_integer, default=8,
        help="Tiles per forward baked into the artifact.",
    )
    export.add_argument(
        "--platforms", type=str, default="cuda,cpu",
        help="Comma-separated devices the artifact may be loaded on: "
             "cuda and/or cpu.",
    )
    export.add_argument(
        "--bf16", action="store_true",
        help="Bake bfloat16 compute into the artifact (the serving "
             "precision on the card); inputs and outputs stay float32 "
             "and the sidecar records compute_dtype. Quantify the "
             "quality cost beforehand with `eval --bf16`.",
    )
    export.add_argument(
        "--native-kernels", action="store_true",
        help="Bake the RDB operator (torchsr_tpu_torch::rdb_fwd) into an "
             "ESRGAN artifact: on CUDA it launches the Hopper RDB kernel, "
             "on the CPU its plain version. The artifact then loads with "
             "the port's ops package imported (the portable default "
             "loads with torch alone).",
    )
    export.add_argument(
        "--seed", type=int, default=0,
        help="Unused at export; accepted for CLI compatibility.",
    )
    _add_device(export)

    serve = commands.add_parser(
        "serve",
        help="Run an HTTP serving daemon around a serving artifact or a "
             "trained checkpoint: POST /upscale (image in, 4x PNG out, "
             "any frame size via tiling), GET /healthz (readiness-gated), "
             "GET /metadata, GET /metrics.",
    )
    serve.add_argument(
        "artifact", type=str, nargs="?", default=None,
        help="Serving artifact produced by `export`. Omit to serve a "
             "checkpoint through the live generator instead.",
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
             "ESRGAN, 256 for SRGAN and HAT).",
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
        "--shard-tiles", action="store_true",
        help="Checkpoint backend: shard each frame's tile batches over "
             "all devices (a generator replica a device; see "
             "infer/multichip.py) - scale-out serving on one host.",
    )
    serve.add_argument(
        "--batch-requests", action="store_true",
        help="Checkpoint backend: coalesce tiles from concurrent "
             "requests into shared device batches (infer/batching.py). "
             "Frames that cannot fill --tile-batch alone ride one "
             "forward together; big frames keep the on-device tiled "
             "path.",
    )
    serve.add_argument(
        "--batch-wait-ms", type=float, default=2.0,
        help="Dynamic batching: how long the device worker waits after "
             "the first queued tile for the batch to fill before "
             "launching short.",
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
        "--artifact", type=str,
        help="Score a serving artifact (`export`) instead of a "
             "checkpoint: the exact program a serving fleet runs. "
             "Overrides --checkpoint/--tile.",
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

    pack = commands.add_parser(
        "pack",
        help="Decode a dataset directory once into a .tsrpack archive of "
             "raw uint8 images (the JAX package's format); train and "
             "eval then read it through mmap (--train-dir, --eval-dir "
             "and eval's image_dir take the archive wherever they take "
             "a directory).",
    )
    pack.add_argument(
        "source", type=str,
        help="Dataset directory of .png/.jpg/.jpeg images.",
    )
    pack.add_argument(
        "output", type=str,
        help="Output archive path (conventionally .tsrpack).",
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
    doctor.add_argument(
        "--no-device-check", action="store_true",
        help="Skip the tiny matmul on the card (leaves the card alone, "
             "e.g. while a benchmark owns it).",
    )

    args = parser.parse_args(argv)
    crop = getattr(args, "crop_size", None)
    upscale = getattr(args, "upscale_factor", 4)
    if crop and crop % upscale:
        parser.error(
            f"--crop-size ({crop}) must be divisible by --scale "
            f"({upscale}): the LR crop is their quotient"
        )
    tile = getattr(args, "tile", 0)
    if tile and getattr(args, "tile_overlap", 0) >= tile:
        parser.error(
            f"--tile-overlap ({args.tile_overlap}) must be smaller "
            f"than --tile ({tile}): the tiling stride is their "
            f"difference and must stay positive"
        )
    if getattr(args, "artifact", None) and getattr(args, "bf16", False):
        parser.error(
            "--bf16 cannot be combined with --artifact: a serving "
            "artifact's compute precision is baked in at export time "
            "(score the checkpoint with --bf16, or export and score the "
            "artifact as-is)"
        )
    if (args.function == "serve" and args.artifact
            and (args.checkpoint or args.batch_requests)):
        parser.error(
            "pass either a serving-artifact path or --checkpoint (with "
            "--batch-requests), not both"
        )
    if getattr(args, "shard_tiles", False):
        if getattr(args, "spatial_shard", False):
            parser.error(
                "--shard-tiles and --spatial-shard are alternative "
                "multi-device strategies; pick one"
            )
        if getattr(args, "artifact", None):
            parser.error(
                "--shard-tiles needs the checkpoint backend (a serving "
                "artifact is one exported program on one device); drop "
                "the artifact path and pass --model/--checkpoint"
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
    elif args.function == "export":
        from torchsr_tpu_torch.infer.runner import run_export

        out = run_export(args, select_test_model(args))
        print(f"Saved serving artifact to {out}")
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
    elif args.function == "pack":
        from torchsr_tpu_torch.data.packed import pack_dataset

        pack_dataset(args.source, args.output, log=print)
    elif args.function == "doctor":
        from torchsr_tpu_torch.utils.doctor import run_doctor

        run_doctor(args)


if __name__ == "__main__":
    main()
