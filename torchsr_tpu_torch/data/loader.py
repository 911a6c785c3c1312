"""Host-side loaders: threaded decode, uint8 crops, flip bits.

The port of ``torchsr_tpu/data/loader.py`` (one process: no host
sharding).  Decoded images sit in a bounded LRU cache in host RAM; each
sample's crop position and flips are a splitmix64 hash of (seed, epoch,
sample index), and the epoch order a permutation drawn from
``numpy.random.default_rng((seed, epoch))``, regrouped into windows by
the same generator under ``shuffle_window``, so for one seed and one
dataset the uint8 crops and flip bits are byte-identical to the JAX
package's.  A dataset is a directory or a pack (``data/packed.py``): a
pack's reader is its own cache (the OS page cache), so the RAM cache
then holds nothing, and the crops sliced from its read-only views are
copied into the batch.  Train batches drop the final partial batch;
eval batches are padded and carry their count of valid samples.  A
``dataset_multiplier`` of N repeats the name list N times in both
loaders, the JAX loaders' semantics: each repeat is a sample index of
its own, so it draws its own crop and flips.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from torchsr_tpu_torch.utils.image_io import load_image


class _ImageCache:
    """Bounded in-RAM LRU cache of decoded images (thread-safe).
    Decoding happens outside the lock; a concurrent duplicate decode of
    one image is possible but harmless."""

    def __init__(self, max_bytes: int, reader=load_image) -> None:
        self._max_bytes = max_bytes
        self._reader = reader
        self._used = 0
        self._lock = threading.Lock()
        self._data: "OrderedDict[str, np.ndarray]" = OrderedDict()

    def get(self, path: str) -> np.ndarray:
        with self._lock:
            cached = self._data.get(path)
            if cached is not None:
                self._data.move_to_end(path)
                return cached
        arr = self._reader(path)
        with self._lock:
            if path not in self._data:
                while self._data and self._used + arr.nbytes > self._max_bytes:
                    _, old = self._data.popitem(last=False)
                    self._used -= old.nbytes
                if self._used + arr.nbytes <= self._max_bytes:
                    self._data[path] = arr
                    self._used += arr.nbytes
        return arr


_M64 = (1 << 64) - 1
# RAM budgets of the decode caches (the JAX loaders' defaults)
_TRAIN_CACHE_BYTES = 32 << 30
_EVAL_CACHE_BYTES = 8 << 30


def _splitmix64(x: int) -> int:
    """One splitmix64 mixing round (per-sample randomness in O(1))."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & _M64


def _sample_randoms(seed: int, epoch: int, idx: int) -> tuple[int, int, int]:
    """Three deterministic 64-bit values for (crop_y, crop_x, flips)."""
    r0 = _splitmix64(
        ((seed + 1) * 0x9E3779B97F4A7C15 + (epoch + 1)) & _M64
    )
    r0 = _splitmix64(r0 ^ idx)
    r1 = _splitmix64(r0)
    r2 = _splitmix64(r1)
    return r0, r1, r2


def _crop_at(img: np.ndarray, size: int, r0: int, r1: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h < size or w < size:
        raise ValueError(
            f"image {(h, w)} smaller than crop size {size}; the "
            "dataset must contain images at least crop_size x crop_size"
        )
    top = r0 % (h - size + 1)
    left = r1 % (w - size + 1)
    return img[top:top + size, left:left + size]


def _cache_for(reader, max_bytes: int) -> _ImageCache:
    """The decode cache: up to ``max_bytes`` of decoded files, or
    nothing in front of a custom ``reader`` (a pack's views), which is
    its own cache."""
    if reader is None:
        return _ImageCache(max_bytes)
    return _ImageCache(0, reader)


class TrainLoader:
    """Epoch loader of (uint8 HR crops (B, S, S, 3), flip bits (B, 2)).

    ``shuffle_window`` > 0 visits windows of that many samples in a
    random order, the samples shuffled within each, instead of one
    global permutation: a decode cache that holds a window then decodes
    each image once an epoch however large the dataset.  ``reader``
    maps a name to its image (a pack's ``get``); by default names are
    files, decoded and cached.  ``num_shards`` / ``shard_index``: this
    rank's share of every epoch under data parallelism, as the JAX
    loader draws it (the permutation padded by wrapping to a multiple
    of the shard count, DistributedSampler-style, then interleaved;
    windows are cut within the shard)."""

    def __init__(
        self,
        paths: list[str],
        batch_size: int,
        crop_size: int,
        dataset_multiplier: int = 1,
        workers: int = 16,
        seed: int = 0,
        shuffle_window: int = 0,
        reader=None,
        num_shards: int = 1,
        shard_index: int = 0,
    ) -> None:
        if not paths:
            raise ValueError("TrainLoader needs at least one image")
        self.paths = list(paths) * dataset_multiplier
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.shuffle_window = int(shuffle_window)
        self._cache = _cache_for(reader, _TRAIN_CACHE_BYTES)
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers))
        # full batches of a shard only (a tiny dataset wraps to fill one)
        per_shard = -(-len(self.paths) // num_shards)
        self.batches_per_epoch = max(1, per_shard // batch_size)
        self.samples_per_epoch = self.batches_per_epoch * batch_size

    def __len__(self) -> int:
        return self.batches_per_epoch

    @property
    def dataset_len(self) -> int:
        return len(self.paths)

    def _sample(self, path: str, epoch: int, idx: int):
        r0, r1, r2 = _sample_randoms(self.seed, epoch, idx)
        crop = _crop_at(self._cache.get(path), self.crop_size, r0, r1)
        flips = np.array([r2 & 1, (r2 >> 1) & 1], dtype=bool)
        return crop, flips

    def _window_reorder(self, order: np.ndarray, rng) -> np.ndarray:
        """``order`` cut into windows of ``shuffle_window`` samples,
        visited in a random order and shuffled within each (the JAX
        loader's draws from ``rng``, in its order); unchanged without a
        window or when one window holds it all."""
        w = self.shuffle_window
        if w <= 0 or w >= len(order):
            return order
        windows = [order[i:i + w] for i in range(0, len(order), w)]
        out = []
        for wi in rng.permutation(len(windows)):
            win = windows[int(wi)]
            out.append(win[rng.permutation(len(win))])
        return np.concatenate(out)

    def epoch(self, epoch_idx: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Iterate one epoch's batches of this shard (0-based
        ``epoch_idx``)."""
        n = len(self.paths)
        rng = np.random.default_rng((self.seed, epoch_idx))
        order = rng.permutation(n)
        total = -(-n // self.num_shards) * self.num_shards
        if total > n:
            order = np.concatenate([order, order[: total - n]])
        order = order[self.shard_index::self.num_shards]
        if len(order) < self.samples_per_epoch:
            order = np.tile(order, -(-self.samples_per_epoch // len(order)))
        order = self._window_reorder(order[: self.samples_per_epoch], rng)
        bs = self.batch_size
        for b in range(self.batches_per_epoch):
            idx = order[b * bs:(b + 1) * bs]
            results = list(self._pool.map(
                lambda i: self._sample(self.paths[int(i)], epoch_idx,
                                       int(i)),
                idx,
            ))
            yield (np.stack([r[0] for r in results]),
                   np.stack([r[1] for r in results]))


class EvalLoader:
    """Deterministic eval loader of padded uint8 crop batches: yields
    ``(crops_u8, valid)``; crops are a fixed function of (seed, image
    index), the same every epoch.  ``num_shards`` / ``shard_index``:
    every ``num_shards``-th image from ``shard_index``, as the JAX
    loader shards."""

    def __init__(
        self,
        paths: list[str],
        batch_size: int,
        crop_size: int,
        dataset_multiplier: int = 1,
        workers: int = 16,
        seed: int = 0,
        reader=None,
        num_shards: int = 1,
        shard_index: int = 0,
    ) -> None:
        if not paths:
            raise ValueError("EvalLoader needs at least one image")
        self.paths = list(paths) * dataset_multiplier
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.seed = seed
        self._cache = _cache_for(reader, _EVAL_CACHE_BYTES)
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers))
        self.indices = np.arange(len(self.paths))[shard_index::num_shards]
        self.batches_per_epoch = -(-len(self.indices) // batch_size)

    def __len__(self) -> int:
        return self.batches_per_epoch

    @property
    def dataset_len(self) -> int:
        return len(self.paths)

    def _sample(self, i: int) -> np.ndarray:
        r0, r1, _ = _sample_randoms(self.seed, -1, int(i))
        return _crop_at(self._cache.get(self.paths[int(i)]), self.crop_size,
                        r0, r1)

    def __iter__(self) -> Iterator[tuple[np.ndarray, int]]:
        bs = self.batch_size
        for b in range(self.batches_per_epoch):
            idx = self.indices[b * bs:(b + 1) * bs]
            crops = list(self._pool.map(self._sample, idx))
            valid = len(crops)
            crops += [np.zeros_like(crops[0])] * (bs - valid)
            yield np.stack(crops), valid


def dataset_source(path: str) -> tuple[list[str], object]:
    """(names, reader or None) of a dataset directory or a pack; a pack
    lists its entries in ``discover_images`` order, so both forms of one
    dataset split and batch alike."""
    from torchsr_tpu_torch.data.discovery import discover_images
    from torchsr_tpu_torch.data.packed import PackedDataset, is_pack

    if is_pack(path):
        pack = PackedDataset(path)
        return pack.names, pack.get
    return discover_images(path), None


def initialize_datasets(
    train_directory: str, batch_size: int, crop_size: int = 128,
    dataset_multiplier: int = 1, workers: int = 16, seed: int = 0,
    eval_directory: str | None = None, shuffle_window: int = 0,
    num_shards: int = 1, shard_index: int = 0,
) -> tuple[TrainLoader, EvalLoader, int, int]:
    """Discover (a directory or a pack), split 90/10 by ``seed``, and
    build the loaders: (train_loader, test_loader, train_len, test_len),
    the reference's ``initialize_datasets`` contract.  With
    ``eval_directory`` the eval loader takes all of it and training all
    of ``train_directory``.  Each loader decodes and crops on
    ``workers`` threads.  ``num_shards`` / ``shard_index`` shard the
    training loader only: every rank evaluates the whole eval set, so
    a data-parallel run's eval reads as one process's."""
    from torchsr_tpu_torch.data.discovery import split_dataset

    images, train_reader = dataset_source(train_directory)
    if eval_directory:
        train_paths = images
        test_paths, eval_reader = dataset_source(eval_directory)
        if not test_paths:
            raise ValueError(
                f"no supported images found in eval dir {eval_directory}")
    else:
        train_paths, test_paths = split_dataset(images, 0.1, seed)
        eval_reader = train_reader
    train_loader = TrainLoader(train_paths, batch_size, crop_size,
                               dataset_multiplier=dataset_multiplier,
                               workers=workers, seed=seed,
                               shuffle_window=shuffle_window,
                               reader=train_reader, num_shards=num_shards,
                               shard_index=shard_index)
    eval_loader = EvalLoader(test_paths, batch_size, crop_size,
                             dataset_multiplier=dataset_multiplier,
                             workers=workers, seed=seed, reader=eval_reader)
    return (train_loader, eval_loader, train_loader.dataset_len,
            eval_loader.dataset_len)
