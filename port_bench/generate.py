"""The general traffic generator: every mix is a data file under
``traffic/`` that one of these readers turns into work from ``--seed``.

``frames`` mixes (serving): a closed loop of ``clients`` clients (one
today), each sending its next frame when the last one came back.
Frame sizes come in decks: ``deck`` lists each LR size ``[h, w]`` and
how many requests of a deck have it; the seed shuffles the order within
each deck, so every seed sends the same mix of work in another order.
The pixels are seeded uint8 noise, ``variants`` frames a size made in
set-up, request ``i`` using variant ``(i // deck length) % variants``.

``crops`` mixes (training): an epoch of ``batches_per_epoch`` batches of
``batch`` uint8 HR crops of ``crop`` pixels and their two flip bits,
made once in host RAM from the seed (``numpy.random.default_rng``),
epochs back to back.  Each crop is uniform noise mapped through its own
brightness and contrast (``mean`` and ``contrast`` ranges: a level v
becomes ``mean + contrast * (v / 255 - 0.5)``, rounded and clipped), so
that rows differ as photo crops do, and a step that left rows out
would read other losses.  ``phase`` (``gan`` or ``pretrain``),
``steps_per_call`` (0: the trainer's default for the phase) and ``lr``
(fixed) say how the steps run.
"""

from __future__ import annotations

import numpy as np


class Frames:
    """A ``frames`` mix for one seed."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.deck = [tuple(d["lr_hw"]) for d in mix["deck"]
                     for _ in range(d["count"])]
        self.sizes = [tuple(d["lr_hw"]) for d in mix["deck"]]
        self.seed = int(seed)
        rng = np.random.default_rng([self.seed % (1 << 64), 1])
        self._frames = {
            size: [rng.integers(0, 256, (*size, 3), dtype=np.uint8)
                   for _ in range(mix["variants"])] for size in self.sizes}
        self._orders: list[list] = []
        self._order_rng = np.random.default_rng([self.seed % (1 << 64), 2])

    def _deck_order(self, k: int) -> list:
        while len(self._orders) <= k:
            perm = self._order_rng.permutation(len(self.deck))
            self._orders.append([self.deck[j] for j in perm])
        return self._orders[k]

    def request(self, i: int) -> tuple[tuple, np.ndarray]:
        """The ``i``-th request's LR size and frame."""
        n = len(self.deck)
        size = self._deck_order(i // n)[i % n]
        return size, self.frame(size, (i // n) % self.mix["variants"])

    def frame(self, size: tuple, variant: int) -> np.ndarray:
        return self._frames[tuple(size)][variant]

    def sample(self, per_size: int, decks: int) -> list[int]:
        """Request indices to check, drawn from the seed among the first
        ``decks`` decks: ``per_size`` of each size, the largest size
        always among them."""
        rng = np.random.default_rng([self.seed % (1 << 64), 3])
        n = len(self.deck)
        chosen = []
        for size in self.sizes:
            idx = [i for i in range(decks * n)
                   if self._deck_order(i // n)[i % n] == size]
            chosen += [int(j) for j in rng.choice(idx, per_size,
                                                  replace=False)]
        return sorted(chosen)


class Crops:
    """A ``crops`` mix for one seed: the epoch's host arrays."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        n, b, s = mix["batches_per_epoch"], mix["batch"], mix["crop"]
        rng = np.random.default_rng([int(seed) % (1 << 64), 4])
        self.crops = rng.integers(0, 256, (n, b, s, s, 3), dtype=np.uint8)
        self.flips = rng.random((n, b, 2)) < 0.5
        mean = rng.uniform(*mix["mean"], (n, b, 1))
        contrast = rng.uniform(*mix["contrast"], (n, b, 1))
        levels = np.arange(256) / 255.0 - 0.5
        lut = np.clip(np.rint(255.0 * (mean + contrast * levels)), 0, 255)
        lut = lut.astype(np.uint8).reshape(n, b * 256)
        rows = (np.arange(b, dtype=np.int32) * 256)[:, None, None, None]
        for i in range(n):  # each row through its own table
            self.crops[i] = lut[i][rows + self.crops[i]]

    def batch(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        j = i % len(self.crops)
        return self.crops[j], self.flips[j]

    def stream(self, start: int, stop=None, stop_event=None):
        """Batches ``start``, ``start + 1``, ... (epochs back to back),
        up to ``stop`` or until ``stop_event`` is set."""
        i = start
        while (stop is None or i < stop) and not (
                stop_event is not None and stop_event.is_set()):
            yield self.batch(i)
            i += 1


class Loader:
    """What the trainer's constructor reads of a loader (its batch and
    crop size, the dataset's length); the benchmark feeds the steps
    itself."""

    def __init__(self, batch_size: int, crop_size: int, n_batches: int):
        self.batch_size, self.crop_size = batch_size, crop_size
        self.dataset_len = batch_size * n_batches
