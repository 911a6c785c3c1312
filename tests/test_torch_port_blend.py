"""The port's tile blend (``infer/tiled.py`` ``blend_tiles``, a gather
over the few tiles that cover each pixel) against the JAX package's
``tiled_upscale`` (a ``lax.scan`` overlap-add) and against the loop the
port blended with before, kept here as a reference.

The tile forward is a stand-in the two packages compute alike in f32: a
nearest 4x upsample of the tile, squared, plus a ramp over the tile's
own pixels, so that overlapping tiles disagree where they overlap and
the blend weights show.  Cases cover K = 2 and K = 3 tiles a pixel a
axis (K = ceil(tile / (tile - overlap)), one more where the last tile is
clamped), ragged frames, a frame smaller than a tile and no overlap.
Tolerance: 1e-5 relative to the output's largest value, against JAX (a
different order of f32 operations is allowed; measured <= 2.5e-7); the loop
reference must be equal to the last bit (same products, same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsr_tpu.infer.tiled import tiled_upscale as jax_tiled_upscale
from torchsr_tpu_torch.infer.tiled import (
    _blend_window,
    _cover,
    _positions,
    _reflect_index,
    blend_tiles,
    tile_forward,
    tiled_upscale,
)

RTOL = 1e-5
SCALE = 4


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stand_in(batch):
    """(B, t, t, 3) -> (B, 4t, 4t, 3), in numpy, JAX or torch alike."""
    t4 = batch.shape[1] * SCALE
    if isinstance(batch, torch.Tensor):
        up = batch.repeat_interleave(SCALE, 1).repeat_interleave(SCALE, 2)
        ramp = torch.arange(t4, dtype=torch.float32) / t4
    else:
        up = jnp.repeat(jnp.repeat(batch, SCALE, 1), SCALE, 2)
        ramp = jnp.arange(t4, dtype=jnp.float32) / t4
    return up * up + ramp[:, None, None]


def _loop_blend(sr, grid, padded_hw, tile, overlap):
    """The port's previous blend: two slice-adds a tile, in tile order."""
    t4 = tile * SCALE
    window = torch.from_numpy(_blend_window(t4, overlap * SCALE))
    ph, pw = padded_hw
    acc = torch.zeros((ph * SCALE, pw * SCALE, 3))
    wacc = torch.full((ph * SCALE, pw * SCALE, 1), 1e-8)
    for j, (y, x) in enumerate(grid):
        y4, x4 = y * SCALE, x * SCALE
        acc[y4:y4 + t4, x4:x4 + t4] += sr[j] * window
        wacc[y4:y4 + t4, x4:x4 + t4] += window
    return acc / wacc


CASES = [
    # (frame hw, tile, overlap, tile batch): K along each axis
    ((40, 52), 16, 4, 3),    # stride 12: K = 2, clamped last tiles
    ((44, 52), 16, 4, 5),    # K = 2, the last chunk padded
    ((37, 50), 16, 10, 4),   # stride 6: K = 3, ragged both ways
    ((45, 29), 16, 11, 2),   # stride 5: K = 4 with the clamped tile
    ((10, 13), 16, 4, 2),    # smaller than a tile: reflect-padded
    ((20, 13), 16, 0, 4),    # no overlap, one side padded
    ((33, 33), 8, 3, 7),     # many small tiles, ragged
]


@pytest.mark.parametrize("hw, tile, overlap, tile_batch", CASES)
def test_blend_matches_jax(hw, tile, overlap, tile_batch):
    image = np.random.default_rng(sum(hw) + tile).random((*hw, 3),
                                                         np.float32)
    want = np.asarray(jax_tiled_upscale(
        _stand_in, jnp.asarray(image), scale=SCALE, tile=tile,
        overlap=overlap, tile_batch=tile_batch))
    got = tiled_upscale(_stand_in, torch.from_numpy(image), scale=SCALE,
                        tile=tile, overlap=overlap,
                        tile_batch=tile_batch).numpy()
    assert got.shape == (hw[0] * SCALE, hw[1] * SCALE, 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("hw, tile, overlap, tile_batch", CASES)
def test_blend_equals_the_loop_reference(hw, tile, overlap, tile_batch):
    del tile_batch  # the blend sees the tiles, not their batching
    image = torch.from_numpy(np.random.default_rng(7).random((*hw, 3),
                                                             np.float32))
    h, w = hw
    image = image[_reflect_index(max(h, tile), h, "cpu")[:, None],
                  _reflect_index(max(w, tile), w, "cpu")[None, :]]
    ph, pw = image.shape[:2]
    grid = [(y, x) for y in _positions(ph, tile, tile - overlap)
            for x in _positions(pw, tile, tile - overlap)]
    tiles = torch.stack([image[y:y + tile, x:x + tile] for y, x in grid])
    sr = _stand_in(tiles)
    want = _loop_blend(sr, grid, (ph, pw), tile, overlap)
    got = blend_tiles(sr, (ph, pw), tile, overlap, SCALE)
    assert torch.equal(got, want)
    assert torch.equal(blend_tiles(sr, (ph, pw), tile, overlap, SCALE), got)


@pytest.mark.parametrize("size, tile, overlap", [
    (52, 16, 4), (37, 16, 10), (29, 16, 11), (16, 16, 4), (64, 16, 0),
    (1920, 64, 8), (1080, 256, 16)])
def test_cover_slots(size, tile, overlap):
    """K slots (the most tiles that cover one pixel, at most
    ceil(tile / stride) + 1); slot 0 covers every pixel; across the slots
    each pixel meets every tile that covers it once, in increasing tile
    order, with that tile's window weight."""
    from torchsr_tpu_torch.infer.tiled import _blend_ramp

    slots = _cover(size, tile, overlap, SCALE)
    t4 = tile * SCALE
    pos = _positions(size, tile, tile - overlap)
    covering = [[i for i, p in enumerate(pos) if p * SCALE <= q
                 < p * SCALE + t4] for q in range(size * SCALE)]
    assert len(slots) == max(map(len, covering))
    assert len(slots) <= -(-tile // (tile - overlap)) + 1
    assert slots[0][0] is None
    ramp = _blend_ramp(t4, overlap * SCALE)
    met = [[] for _ in range(size * SCALE)]
    for pixels, rows, weights in slots:
        pixels = np.arange(size * SCALE) if pixels is None else pixels
        assert len(pixels) == len(rows) == len(weights)
        for q, row, w in zip(pixels, rows, weights):
            met[q].append(row // t4)
            assert row % t4 == q - pos[row // t4] * SCALE
            assert w == ramp[row % t4]
    assert met == covering


def test_tile_forward_on_the_cpu_is_the_module_itself():
    module = torch.nn.Identity()
    assert tile_forward(module, "cpu") is module
