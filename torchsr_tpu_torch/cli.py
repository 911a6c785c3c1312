"""CLI: ``python -m torchsr_tpu_torch test|serve``.

The ported subcommands keep the JAX CLI's flag names and defaults, plus
``--device`` (default ``cuda``: the port runs on the card unless asked
for the CPU, and raises when CUDA is absent).  Subcommands and flags
that are not ported yet are not registered (ROADMAP.md, queue A).
"""

from __future__ import annotations

import os
from argparse import ArgumentParser, ArgumentTypeError, Namespace

from torchsr_tpu_torch.__version__ import VERSION
from torchsr_tpu_torch.constants import MODEL
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
    if args.function == "test":
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
