"""The port's training data path and metrics against the JAX package's.

For one seed and one image directory the port's loaders must yield the
JAX loaders' uint8 crops and flip bits byte for byte (same split, same
epoch order, same splitmix64 crops and flips); the on-device pair
synthesis, the losses and the metrics agree on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchsr_tpu.data import loader as jax_loader
from torchsr_tpu.data.discovery import split_dataset as jax_split
from torchsr_tpu.data.preprocess import (
    synthesize_eval_triple as jax_eval_triple,
)
from torchsr_tpu.data.preprocess import synthesize_pair as jax_pair
from torchsr_tpu.ops.resize import resample_matrix as jax_resample_matrix
from torchsr_tpu.train import losses as jax_losses
from torchsr_tpu.train import metrics as jax_metrics
from torchsr_tpu_torch.data import loader
from torchsr_tpu_torch.data.discovery import discover_images, split_dataset
from torchsr_tpu_torch.data.prefetch import prefetch_to_device
from torchsr_tpu_torch.data.preprocess import (
    synthesize_eval_triple,
    synthesize_pair,
)
from torchsr_tpu_torch.ops.resize import bicubic_resize, resample_matrix
from torchsr_tpu_torch.train import losses, metrics

# The pair synthesis: uint8 -> f32 is the same product (k * f32(1/255),
# as XLA compiles the JAX package's ``/ 255.0``), so HR is equal bit for
# bit.  LR and the re-upscale are the same f32 matmuls and uint8
# quantization, so every value lands on the same k/255 grid -- except at
# rounding ties of the quantization (a sum that is k + 1/2 levels in
# exact arithmetic), where the two f32 sums, taken in other orders,
# round one level (1/255) apart.  Measured on seeded (16, 128, 128, 3)
# crops: 6 of 49,152 LR values (0.012%) and 169 of 786,432 re-upscaled
# values (0.02%).
ATOL_SYNTH = 1e-6
TIE_FRACTION = 1e-3
# f32 reductions in other orders
RTOL_METRIC = 1e-5


def _assert_synth_close(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got - want)
    assert float(diff.max()) <= 1 / 255 + ATOL_SYNTH, float(diff.max())
    assert float((diff > 0).mean()) <= TIE_FRACTION


@pytest.mark.parametrize("seed", [0, 3])
def test_loaders_are_byte_identical_to_jax(image_dir, seed):
    ours = loader.initialize_datasets(image_dir, 4, 32, seed=seed)
    theirs = jax_loader.initialize_datasets(image_dir, batch_size=4,
                                            crop_size=32, seed=seed)
    assert ours[2:] == theirs[2:]  # train_len, test_len
    assert ours[0].paths == theirs[0].paths
    assert ours[1].paths == theirs[1].paths
    assert len(ours[0]) == len(theirs[0])
    for epoch in (0, 1, 5):
        got = list(ours[0].epoch(epoch))
        want = list(theirs[0].epoch(epoch))
        assert len(got) == len(want) > 0
        for (c, f), (wc, wf) in zip(got, want):
            assert c.dtype == np.uint8 and c.shape == (4, 32, 32, 3)
            np.testing.assert_array_equal(c, wc)
            np.testing.assert_array_equal(f, wf)
    got = list(ours[1])
    want = list(theirs[1])
    assert len(got) == len(want) > 0
    for (c, v), (wc, wv) in zip(got, want):
        assert v == wv
        np.testing.assert_array_equal(c, wc)


def test_tiny_dataset_wraps_like_jax(image_dir):
    paths = discover_images(image_dir)[:3]
    got = list(loader.TrainLoader(paths, 8, 32, seed=1).epoch(0))
    want = list(jax_loader.TrainLoader(paths, 8, 32, seed=1).epoch(0))
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0][0], want[0][0])
    np.testing.assert_array_equal(got[0][1], want[0][1])


def test_split_matches_jax(image_dir):
    images = discover_images(image_dir)
    for seed in (0, 1, 7):
        assert split_dataset(images, 0.1, seed) == jax_split(images, 0.1,
                                                             seed)
    with pytest.raises(ValueError):
        split_dataset([], 0.1, 0)
    with pytest.raises(FileNotFoundError):
        discover_images(image_dir + "-missing")


def test_lru_cache_evicts_the_oldest(image_dir):
    paths = discover_images(image_dir)[:3]
    sizes = [loader.load_image(p).nbytes for p in paths]
    cache = loader._ImageCache(max(sizes[0] + sizes[1], sizes[2]) + 1)
    for p in paths[:2]:
        cache.get(p)
    cache.get(paths[0])  # paths[1] is now the oldest
    cache.get(paths[2])
    assert paths[1] not in cache._data and paths[0] in cache._data


def _crops(seed, b=3, s=32):
    rng = np.random.default_rng(seed)
    crops = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    flips = rng.integers(0, 2, (b, 2)).astype(bool)
    return crops, flips


@pytest.mark.parametrize("size", [32, 48, 128])
def test_synthesize_pair_matches_jax(size):
    crops, flips = _crops(size, s=size)
    want_lr, want_hr = (np.asarray(a) for a in jax_pair(crops, flips, 4))
    lr, hr = synthesize_pair(torch.from_numpy(crops),
                             torch.from_numpy(flips), 4)
    assert lr.shape == (3, size // 4, size // 4, 3)
    assert lr.dtype == torch.float32
    np.testing.assert_array_equal(hr.numpy(), want_hr)
    _assert_synth_close(lr.numpy(), want_lr)


@pytest.mark.parametrize("seed", [5, 9])
def test_synthesize_eval_triple_matches_jax(seed):
    crops, _ = _crops(seed)
    want = [np.asarray(a) for a in jax_eval_triple(crops, 4)]
    lr, bic, hr = synthesize_eval_triple(torch.from_numpy(crops), 4)
    assert bic.shape == hr.shape == crops.shape
    np.testing.assert_array_equal(hr.numpy(), want[2])
    _assert_synth_close(lr.numpy(), want[0])
    # the re-upscale from the same LR (a tie in LR moves its neighbours)
    up = bicubic_resize(torch.from_numpy(want[0]), crops.shape[1:3],
                        quantize=True)
    _assert_synth_close(up.numpy(), want[1])


def test_uint8_to_f32_matches_jax_for_every_value():
    """All 256 uint8 values read as the JAX package reads them, bit for
    bit: a true division by 255 differs at 126 of them."""
    values = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    crops = np.repeat(values, 3, axis=-1)
    flips = np.zeros((1, 2), dtype=bool)
    want = np.asarray(jax_pair(crops, flips, 4)[1])
    _, hr = synthesize_pair(torch.from_numpy(crops), torch.from_numpy(flips))
    np.testing.assert_array_equal(hr.numpy(), want)
    up = bicubic_resize(torch.from_numpy(crops), (16, 16))
    np.testing.assert_array_equal(up.numpy(), want)
    divided = torch.from_numpy(crops).float() / 255.0
    assert int((divided.numpy() != want).sum()) == 3 * 126


@pytest.mark.parametrize("sizes", [(128, 32), (32, 128), (37, 9)])
def test_resample_matrix_matches_jax(sizes):
    np.testing.assert_array_equal(resample_matrix(*sizes),
                                  jax_resample_matrix(*sizes))


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    a = rng.random((3, 8, 8, 3)).astype(np.float32)
    b = rng.random((3, 8, 8, 3)).astype(np.float32)
    logits = rng.normal(0, 3, (5, 1)).astype(np.float32)
    probs = np.concatenate([rng.random((3, 1)), [[0.0], [1.0]]]).astype(
        np.float32)
    targets = (rng.random((5, 1)) > 0.5).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (losses.l1_loss(t(a), t(b)), jax_losses.l1_loss(a, b)),
        (losses.mse_loss(t(a), t(b)), jax_losses.mse_loss(a, b)),
        (losses.bce_loss(t(probs), t(targets)),
         jax_losses.bce_loss(probs, targets)),
        (losses.bce_with_logits_loss(t(logits), t(targets)),
         jax_losses.bce_with_logits_loss(logits, targets)),
    ]
    for got, want in pairs:
        assert torch.isfinite(got)
        np.testing.assert_allclose(float(got), float(want),
                                   rtol=RTOL_METRIC)


def test_psnr_and_ssim_match_jax():
    rng = np.random.default_rng(3)
    a = rng.random((2, 32, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(float(metrics.psnr(t(a), t(b))),
                               float(jax_metrics.psnr(a, b)),
                               rtol=RTOL_METRIC)
    np.testing.assert_allclose(metrics.mse_per_sample(t(a), t(b)).numpy(),
                               np.asarray(jax_metrics.mse_per_sample(a, b)),
                               rtol=RTOL_METRIC)
    np.testing.assert_allclose(
        metrics.ssim_per_sample(t(a), t(b)).numpy(),
        np.asarray(jax_metrics.ssim_per_sample(jnp.asarray(a),
                                               jnp.asarray(b))),
        rtol=RTOL_METRIC, atol=1e-6)


def test_prefetch_keeps_order_and_raises():
    items = [(np.full((2,), i, np.int64),) for i in range(5)]
    got = [int(x[0][0]) for x in prefetch_to_device(iter(items), "cpu")]
    assert got == list(range(5))

    def broken():
        yield (np.zeros(1),)
        raise OSError("decode failed")

    with pytest.raises(OSError, match="decode failed"):
        list(prefetch_to_device(broken(), "cpu"))
