"""Spatially sharded single-image inference: a grid of blocks with halos.

The port of ``torchsr_tpu/infer/halo.py``.  One image is split into a
``(ny, nx)`` grid of contiguous blocks over a device grid
(``make_spatial_mesh``); each device runs the whole generator on its
block extended by an ``overlap``-pixel halo and keeps the block's part
of the result.  The JAX package exchanges the halos with ``ppermute``;
here the image is whole on the host's side (on the image's device), so
each extended block is cut from it directly.  The semantics are the
JAX package's:

* an interior block sees ``overlap`` rows / columns of real neighbour
  pixels on each side;
* a block on the image's edge does not pad with zeros (a zero halo is
  not the generator's own edge padding: biases and activations make a
  conv's output nonzero on zero input): it slides its window inward,
  taking ``2 * overlap`` from its one neighbour, and crops at the
  shifted offset, so the true edge is convolved with the generator's
  own padding as in the monolithic forward.

Beyond the halo a 3x3 conv's padding reaches one pixel further a conv,
so the result is exact against the monolithic forward once ``overlap``
covers the generator's receptive field (in LR pixels); for the full
generators a practical overlap makes it the tiled path's kind of
approximation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torchsr_tpu_torch.infer.tiled import _reflect_index


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """A ``(ny, nx)`` grid of devices, row-major in ``devices``."""

    ny: int
    nx: int
    devices: tuple

    def device(self, iy: int, ix: int) -> torch.device:
        return self.devices[iy * self.nx + ix]


def make_spatial_mesh(devices: list, ny: int | None = None,
                      nx: int | None = None) -> SpatialMesh:
    """The grid over ``devices``: with neither side given, the device
    count factored as near-square as it goes (8 -> 2 x 4); a given side
    must divide the count."""
    n = len(devices)
    if ny is None and nx is None:
        ny = int(np.sqrt(n))
        while n % ny:
            ny -= 1
        nx = n // ny
    elif ny is None:
        ny = n // nx
    elif nx is None:
        nx = n // ny
    if ny * nx != n:
        raise ValueError(f"mesh {ny}x{nx} != {n} devices")
    return SpatialMesh(ny, nx, tuple(torch.device(d) for d in devices))


def _window(i: int, n: int, block: int, o: int) -> tuple[int, int, int]:
    """(start, length, crop offset) of block ``i`` of ``n`` along one
    axis, extended by ``o``: the first block takes ``2o`` past its end,
    the last ``2o`` before its start, an interior one ``o`` each side;
    a lone block is not extended."""
    if n == 1:
        return 0, block, 0
    if i == 0:
        return 0, block + 2 * o, 0
    if i == n - 1:
        return i * block - 2 * o, block + 2 * o, 2 * o
    return i * block - o, block + 2 * o, o


def _pad_index(n_out: int, n: int, reflect: bool, device) -> torch.Tensor:
    if reflect:
        return _reflect_index(n_out, n, device)
    return torch.arange(n_out, device=device).clamp_max(n - 1)


def halo_upscale(infer_fns: list, image: torch.Tensor, mesh: SpatialMesh,
                 *, scale: int = 4, overlap: int = 16) -> torch.Tensor:
    """Upscale an ``(H, W, 3)`` float image over ``mesh``: block (iy, ix)
    through ``infer_fns[iy * nx + ix]`` on ``mesh.device(iy, ix)``;
    each forward maps ``(1, h, w, 3)`` to ``(1, h*scale, w*scale, 3)``
    for any size.  Returns ``(H*scale, W*scale, 3)`` float32 on the
    image's device."""
    ny, nx = mesh.ny, mesh.nx
    if len(infer_fns) != ny * nx:
        raise ValueError(f"one forward a device: {ny * nx}, got "
                         f"{len(infer_fns)}")
    home = image.device
    h, w = image.shape[:2]
    bh, bw = -(-h // ny), -(-w // nx)
    # blocks of at least 2 * overlap, so that an edge block's window
    # fits in its neighbour
    min_h, min_w = max(2 * overlap, 1) * ny, max(2 * overlap, 1) * nx
    pad_h = max(ny * bh, min_h) - h
    pad_w = max(nx * bw, min_w) - w
    with torch.inference_mode():
        image = image.float()
        if pad_h or pad_w:
            # reflect (as the tiled path) unless the image is smaller
            # than the pad, where reflect is undefined: then the edge
            reflect = pad_h < h and pad_w < w
            rows = _pad_index(h + pad_h, h, reflect, home)
            cols = _pad_index(w + pad_w, w, reflect, home)
            image = image[rows[:, None], cols[None, :]]
            bh, bw = image.shape[0] // ny, image.shape[1] // nx
        out = torch.empty((ny * bh * scale, nx * bw * scale, 3),
                          device=home)
        for iy in range(ny):
            y0, hh, oy = _window(iy, ny, bh, overlap)
            for ix in range(nx):
                x0, ww, ox = _window(ix, nx, bw, overlap)
                ext = image[y0:y0 + hh, x0:x0 + ww].to(mesh.device(iy, ix))
                sr = infer_fns[iy * nx + ix](ext[None])[0]
                out[iy * bh * scale:(iy + 1) * bh * scale,
                    ix * bw * scale:(ix + 1) * bw * scale] = sr[
                    oy * scale:(oy + bh) * scale,
                    ox * scale:(ox + bw) * scale].to(home)
    return out[: h * scale, : w * scale]
