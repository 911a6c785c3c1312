"""The ``test`` and ``export`` subcommands: load a trained generator,
upscale images, or write it as a serving artifact.

Accepts the reference's ``.pth`` and the JAX package's ``.ckpt``,
strips a DDP ``module.`` prefix, names outputs ``upres-{basename}``,
and offers tiled overlap-blend inference (``--tile``; on CUDA each tile
batch replays the generator's captured graph), over several devices
with ``--shard-tiles`` or ``--spatial-shard``.  Runs on the CUDA device
unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
from argparse import Namespace

import numpy as np
import torch

from torchsr_tpu_torch.infer.tiled import tile_forward, upscale_image
from torchsr_tpu_torch.utils import image_io
from torchsr_tpu_torch.utils.checkpoint import (
    find_checkpoint,
    load_checkpoint,
)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and absent, rather than carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' (--device cpu) to run on the "
            f"CPU"
        )
    return dev


def resolve_compute_dtype(args: Namespace, device: torch.device):
    """Inference compute dtype: bfloat16 on CUDA unless ``--disable-amp``,
    float32 on the CPU (whose bf16 convolutions are emulated)."""
    if getattr(args, "disable_amp", False):
        return torch.float32
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def load_trained_generator(
    args: Namespace, generator_cls, *, device: torch.device,
    compute_dtype: torch.dtype,
):
    """Resolve the checkpoint, size the generator to it (block count and
    scale from its keys, ``generator_cls.sized_to``), and return it on
    ``device`` in eval mode (BatchNorm on its running statistics),
    without gradients."""
    model = args.model.lower()
    ckpt_path = getattr(args, "checkpoint", None) or find_checkpoint(
        f"{model}-gan-best.ckpt"
    )
    if ckpt_path is None:
        raise FileNotFoundError(
            f"no checkpoint found (looked for {model}-gan-best.ckpt / "
            f".pth in the working directory); train a model first or "
            f"pass --checkpoint"
        )
    checkpoint = load_checkpoint(ckpt_path, model)
    if checkpoint is None:
        raise FileNotFoundError(f"checkpoint not found: {ckpt_path}")
    state = {k: v if k.endswith("num_batches_tracked") else v.float()
             for k, v in checkpoint["state"].items()}
    generator = generator_cls.sized_to(state, compute_dtype=compute_dtype,
                                       device="meta")
    generator.load_state_dict(state, assign=True)
    return generator.to(device).eval().requires_grad_(False)


def run_test(args: Namespace, generator_cls) -> str:
    """Upscale ``args.image`` (a file, or every supported image in a
    directory) with the best GAN checkpoint; returns the output path
    (one image) or a summary (a directory)."""
    device = resolve_device(getattr(args, "device", "cuda"))
    generator = load_trained_generator(
        args, generator_cls, device=device,
        compute_dtype=resolve_compute_dtype(args, device),
    )

    if getattr(args, "shard_tiles", False) or getattr(
            args, "spatial_shard", False):
        upscale_one = _sharded_upscaler(args, generator, device)
    else:
        forward = tile_forward(generator, device)

        def upscale_one(path: str) -> np.ndarray:
            return upscale_image(
                forward,
                image_io.load_image(path),
                scale=generator.scale_factor,
                tile=getattr(args, "tile", 0) or 0,
                overlap=getattr(args, "tile_overlap", 16),
                tile_batch=getattr(args, "tile_batch", 8),
                device=device,
            )

    if os.path.isdir(args.image):
        paths = image_io.discover_images(args.image)
        if not paths:
            raise ValueError(
                f"no supported images found in directory {args.image}"
            )
        for path in paths:
            out_path = f"upres-{os.path.basename(path)}"
            image_io.save_image(upscale_one(path), out_path)
        return f"{len(paths)} images -> upres-* in {os.getcwd()}"

    out_path = f"upres-{os.path.basename(args.image)}"
    image_io.save_image(upscale_one(args.image), out_path)
    return out_path


def _sharded_upscaler(args: Namespace, generator, device: torch.device):
    """``test``'s upscale over every visible device of ``device``'s kind
    (``parallel/mesh.py`` ``local_devices``): ``--shard-tiles`` spreads
    the tile batches (``infer/multichip.py``; ``--tile`` defaults to the
    model's serving tile), ``--spatial-shard`` splits the image into a
    grid of blocks with ``--tile-overlap`` halos (``infer/halo.py``)."""
    from torchsr_tpu_torch.infer.halo import halo_upscale, make_spatial_mesh
    from torchsr_tpu_torch.infer.multichip import (
        sharded_forwards,
        tiled_upscale_sharded,
    )
    from torchsr_tpu_torch.infer.tiled import DEFAULT_SERVING_TILE
    from torchsr_tpu_torch.parallel.mesh import (
        local_devices,
        replicate_module,
    )

    devices = local_devices(device=device)
    scale = generator.scale_factor
    overlap = getattr(args, "tile_overlap", 16)
    if getattr(args, "shard_tiles", False):
        tile = getattr(args, "tile", 0) or DEFAULT_SERVING_TILE.get(
            args.model.lower(), 64)
        forwards = sharded_forwards(generator, devices)

        def run(x):
            return tiled_upscale_sharded(
                forwards, x, devices, scale=scale, tile=tile,
                overlap=min(overlap, tile - 1),
                tile_batch=getattr(args, "tile_batch", 8))
    else:
        spatial = make_spatial_mesh(devices)
        replicas = replicate_module(generator, list(spatial.devices))

        def run(x):
            return halo_upscale(replicas, x, spatial, scale=scale,
                                overlap=overlap)

    def upscale_one(path: str) -> np.ndarray:
        arr = image_io.load_image(path).astype(np.float32) / 255.0
        out = run(torch.from_numpy(arr).to(devices[0]))
        return out.clamp(0.0, 1.0).cpu().numpy()

    return upscale_one


def run_export(args: Namespace, generator_cls) -> str:
    """The ``export`` subcommand: write a serving artifact
    (``infer/serving.py``) of the checkpoint at ``--tile`` and
    ``--tile-batch``, f32 compute unless ``--bf16``; the trace runs on
    ``--device`` (fake tensors: nothing is launched)."""
    from torchsr_tpu_torch.infer.serving import (
        check_platforms,
        export_generator_artifact,
    )

    model = args.model.lower()
    native = getattr(args, "native_kernels", False)
    if native and model != "esrgan":
        raise ValueError(
            "--native-kernels bakes the RDB operator, which only the "
            f"ESRGAN generator uses; export {model} without it")
    platforms = check_platforms(getattr(args, "platforms",
                                        "cuda,cpu").split(","))
    device = resolve_device(getattr(args, "device", "cuda"))
    generator = load_trained_generator(
        args, generator_cls, device=device,
        compute_dtype=(torch.bfloat16 if getattr(args, "bf16", False)
                       else torch.float32),
    )
    tile = getattr(args, "tile", 64)
    return export_generator_artifact(
        args.output, generator, input_hw=(tile, tile),
        batch=getattr(args, "tile_batch", 8),
        scale=generator.scale_factor, model=model, platforms=platforms,
        native_kernels=native,
    )
