"""Ahead-of-time serving artifacts: ``torch.export`` programs of the
generator.

The port of the JAX package's ``infer/serving.py``.  A serving artifact
is the eval-mode generator's forward exported once with
``torch.export`` at a fixed ``(batch, tile, tile, 3)`` input and saved
with ``torch.export.save`` (a ``.pt2``): the trained weights travel
inside it, and a process that loads it needs no model, trainer or
checkpoint code.  The boundary is float32 in ([0, 1] pixels) and
float32 out whatever the compute dtype baked in (recorded in the
sidecar): the generators cast on the way in and out, and the export
keeps those casts.

Two kinds, as in JAX:

- **portable** (the default): every residual dense block is traced as
  its plain version (``ops.rdb.plain_forward``), so the program is pure
  aten and loads with ``torch`` alone, on the card or the CPU.
- **native kernels** (``native_kernels=True``, ESRGAN only): each block
  is the ``torchsr_tpu_torch::rdb_fwd`` operator (``ops/rdb.py``), which
  launches the Hopper RDB kernel on CUDA (B1, or the variant the knobs
  selected at export) and runs the plain version on the CPU.  Such an
  artifact loads once ``torchsr_tpu_torch.ops`` is imported, which
  registers the operator.

A JSON sidecar next to the program records the JAX sidecar's keys:
model, scale, shapes, dtypes, pixel range, platforms, calling
convention and ``native_kernels``.  ``platforms`` takes ``cuda`` and
``cpu``; loading on a device the artifact was not exported for raises.
The program is saved with its weights on the CPU and moved to the
serving device at load.

``ServedGenerator`` is a loaded artifact, usable directly or as the tile
forward of ``infer/tiled.py``: on CUDA its tile batches replay one
captured CUDA graph (``infer.tiled.tile_forward``).
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np
import torch

SIDECAR_SUFFIX = ".json"
_FORMAT_VERSION = 1
PLATFORMS = ("cuda", "cpu")
RDB_OP = "torchsr_tpu_torch.rdb_fwd"


def check_platforms(platforms: Sequence[str]) -> tuple:
    """The artifact's platforms, each ``cuda`` or ``cpu``."""
    platforms = tuple(p.strip().lower() for p in platforms if p.strip())
    for p in platforms:
        if p not in PLATFORMS:
            hint = (" (this package serves on CUDA cards and the CPU; TPU "
                    "artifacts come from the JAX package's export)"
                    if p == "tpu" else "")
            raise ValueError(f"unknown platform {p!r}: pick from "
                             f"{', '.join(PLATFORMS)}{hint}")
    if not platforms:
        raise ValueError("an artifact needs at least one platform")
    return platforms


def _move(program, device):
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, torch.device(device))


def rdb_op_calls(program) -> int:
    """Calls of the RDB operator in an exported program's graph."""
    return sum(node.op == "call_function" and RDB_OP in str(node.target)
               for node in program.graph.nodes)


def export_generator_artifact(
    out_path: str,
    generator: torch.nn.Module,
    *,
    input_hw: tuple[int, int],
    batch: int = 1,
    scale: int = 4,
    model: str = "",
    platforms: Sequence[str] = PLATFORMS,
    native_kernels: bool = False,
) -> str:
    """Export ``generator``'s eval forward to ``out_path`` (+ sidecar).

    The generator's weights are baked into the program; the program maps
    ``(batch, H, W, 3) float32`` to ``(batch, H*scale, W*scale, 3)
    float32`` whatever its ``compute_dtype`` (recorded).  The trace runs
    on the generator's device with fake tensors: no kernel launches.
    Returns ``out_path``."""
    from torchsr_tpu_torch.ops import rdb as rdb_ops

    platforms = check_platforms(platforms)
    h, w = input_hw
    generator = generator.eval().requires_grad_(False)
    device = next(generator.parameters()).device
    example = torch.zeros((batch, h, w, 3), device=device)
    with torch.no_grad():
        if native_kernels:
            program = torch.export.export(generator, (example,))
        else:
            with rdb_ops.plain_forward():
                program = torch.export.export(generator, (example,))
    calls = rdb_op_calls(program)
    if native_kernels and not calls:
        raise ValueError(
            "--native-kernels bakes the RDB operator, which only the "
            "ESRGAN generator calls; export this model without it")
    torch.export.save(_move(program, "cpu"), out_path)
    compute = getattr(generator, "compute_dtype", None) or torch.float32
    meta = {
        "format_version": _FORMAT_VERSION,
        "model": model,
        "scale": int(scale),
        "input_shape": [int(batch), int(h), int(w), 3],
        "output_shape": [int(batch), int(h * scale), int(w * scale), 3],
        "dtype": "float32",
        "compute_dtype": str(compute).removeprefix("torch."),
        "pixel_range": [0.0, 1.0],
        "platforms": list(platforms),
        "calling_convention": "sr = f(lr_batch)",
        # True when the graph calls torchsr_tpu_torch::rdb_fwd: the
        # Hopper RDB kernel on CUDA, loadable with the port's ops only
        "native_kernels": bool(native_kernels),
    }
    with open(out_path + SIDECAR_SUFFIX, "w") as fh:
        json.dump(meta, fh, indent=2)
    return out_path


class ServedGenerator:
    """A loaded serving artifact on ``device`` (``"cuda"`` unless the
    caller asks for the CPU), usable directly or as the ``infer_fn`` of
    the tiled and whole-image upscale helpers."""

    def __init__(self, path: str, device: str | torch.device = "cuda"):
        from torchsr_tpu_torch.infer.runner import resolve_device
        from torchsr_tpu_torch.infer.tiled import tile_forward

        sidecar = path + SIDECAR_SUFFIX
        meta = None
        if os.path.exists(sidecar):
            with open(sidecar) as fh:
                meta = json.load(fh)
        self.device = resolve_device(device)
        platforms = (meta or {}).get("platforms")
        if platforms and self.device.type not in platforms:
            hint = (" (a native-kernel artifact launches the Hopper RDB "
                    "kernel on CUDA)" if meta.get("native_kernels") else "")
            raise RuntimeError(
                f"serving artifact {path!r} was exported for platform(s) "
                f"{platforms} but is being loaded on "
                f"{self.device.type!r}{hint}; re-export with --platforms "
                f"{self.device.type} or serve on a matching host.")
        if meta is None or meta.get("native_kernels"):
            import torchsr_tpu_torch.ops  # noqa: F401  (registers the op)
        program = torch.export.load(path)
        if meta is None:
            # the program alone still runs; synthesize what we can
            name = program.graph_signature.user_inputs[0]
            shape = next(n for n in program.graph.nodes
                         if n.name == name).meta["val"].shape
            meta = {"input_shape": list(shape), "scale": None, "model": ""}
        self.meta = meta
        self.input_shape = tuple(meta["input_shape"])
        self.scale = meta.get("scale")
        self.module = _move(program, self.device).module()
        self._forward = tile_forward(self.module, self.device)

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        """SR of one export-shape float32 batch on the device (a new
        tensor: the graph's output buffer is copied)."""
        with torch.inference_mode():
            return self._forward(batch.to(self.device)).clone()

    def upscale_image(
        self,
        image: np.ndarray,
        overlap: int | None = None,
        quantize_u8: bool = False,
    ) -> np.ndarray:
        """Upscale an (H, W, 3) image of any size: a frame matching the
        export shape runs as one forward; anything else runs through
        overlap-blend tiling with this artifact as the tile forward.

        ``overlap`` defaults to 16 LR pixels, clamped below the tile
        size so the tiling stride stays positive.  ``quantize_u8``
        rounds to uint8 on the device before the host copy (a quarter of
        the f32 frame's bytes)."""
        from torchsr_tpu_torch.infer.tiled import tiled_upscale

        b, th, tw, _c = self.input_shape
        scale = self.scale or 4
        arr = np.asarray(image)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        x = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            self.device)
        with torch.inference_mode():
            if b == 1 and tuple(x.shape[:2]) == (th, tw):
                out = self._forward(x[None])[0]
            else:
                if th != tw:
                    raise ValueError(
                        f"tiled serving needs a square export shape, got "
                        f"{(th, tw)}")
                if overlap is None:
                    overlap = min(16, max(th // 4, 1))
                # clamp explicit values too: the stride must stay positive
                overlap = min(overlap, th - 1)
                out = tiled_upscale(self._forward, x, scale=scale, tile=th,
                                    overlap=overlap, tile_batch=b)
            out = out.clamp(0.0, 1.0)
            if quantize_u8:
                out = (out * 255.0 + 0.5).to(torch.uint8)
            return out.cpu().numpy()
