"""Packed datasets and the windowed shuffle against the JAX package.

A pack is a file format two packages share: the JAX ``pack_dataset``
and the port's must write the same bytes from one directory and each
read the other's.  The port's loaders must give the JAX loaders' uint8
crops and flip bits byte for byte, from a directory and from its pack,
with and without ``shuffle_window``; then ``pack`` and ``train --device
cpu`` from the pack run end to end.
"""

import os

import numpy as np
import pytest
import torch

from torchsr_tpu.data import loader as jax_loader
from torchsr_tpu.data import packed as jax_packed
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.data import loader, packed
from torchsr_tpu_torch.utils.image_io import load_image


# for the module, its module fixtures included
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def packs(image_dir, tmp_path_factory):
    """The same directory packed by each package."""
    root = tmp_path_factory.mktemp("packs")
    ours, theirs = str(root / "port.tsrpack"), str(root / "jax.tsrpack")
    assert packed.pack_dataset(image_dir, ours) == 12
    assert jax_packed.pack_dataset(image_dir, theirs) == 12
    return ours, theirs


def test_packs_are_byte_identical_and_cross_read(image_dir, packs):
    ours, theirs = packs
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    names = sorted(os.listdir(image_dir))
    for reader_cls, path in ((packed.PackedDataset, theirs),
                             (jax_packed.PackedDataset, ours)):
        pack = reader_cls(path)
        try:
            assert pack.names == names
            for name in names:
                got = pack.get(name)
                assert not got.flags.writeable
                np.testing.assert_array_equal(
                    got, load_image(os.path.join(image_dir, name)))
            del got  # a view keeps the mapping open
        finally:
            pack.close()
    assert packed.is_pack(ours) and not packed.is_pack(image_dir)


def test_truncated_and_empty_are_refused(packs, tmp_path):
    blob = open(packs[0], "rb").read()
    for i, cut in enumerate((blob[:-5], blob[:24], blob[:8])):
        path = tmp_path / f"cut{i}.tsrpack"
        path.write_bytes(cut)
        with pytest.raises(ValueError, match="truncated"):
            packed.PackedDataset(str(path))
    (tmp_path / "not").write_bytes(b"PNG" + bytes(40))
    with pytest.raises(ValueError, match="not a TSRPACK"):
        packed.PackedDataset(str(tmp_path / "not"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no supported images"):
        packed.pack_dataset(str(tmp_path / "empty"),
                            str(tmp_path / "e.tsrpack"))
    assert not os.path.exists(tmp_path / "e.tsrpack")


def _batches(loaders, epochs=(0, 1)):
    train, ev = loaders[:2]
    return ([b for e in epochs for b in train.epoch(e)], list(ev))


@pytest.mark.parametrize("window", [0, 3, 5])
@pytest.mark.parametrize("source", ["dir", "pack"])
def test_loaders_equal_jax_and_directory(image_dir, packs, source, window):
    """Port from ``source`` == JAX from the same source == port from the
    directory, batch for batch, two epochs and the eval set."""
    path = image_dir if source == "dir" else packs[0]
    kw = dict(dataset_multiplier=2, seed=5, shuffle_window=window,
              workers=2)
    ours = _batches(loader.initialize_datasets(path, 4, 32, **kw))
    theirs = _batches(jax_loader.initialize_datasets(
        path, batch_size=4, crop_size=32, **kw))
    base = _batches(loader.initialize_datasets(image_dir, 4, 32, **kw))
    for other in (theirs, base):
        for got, want in zip(ours[0], other[0]):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        for got, want in zip(ours[1], other[1]):
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
    assert len(ours[0]) == len(theirs[0]) == 2 * (11 * 2 // 4)
    assert all(c.flags.writeable for c, _ in ours[0])


def test_window_changes_the_order_not_the_samples(image_dir):
    plain = loader.TrainLoader(sorted(os.listdir(image_dir)), 4, 32)
    rng = np.random.default_rng(0)
    order = rng.permutation(24)
    plain.shuffle_window = 5
    got = plain._window_reorder(order, np.random.default_rng(1))
    assert sorted(got) == sorted(order) and not np.array_equal(got, order)
    # each window of 5 consecutive samples of ``order`` stays together
    for i in range(0, len(order), 5):
        pos = sorted(int(np.flatnonzero(got == v)[0]) for v in order[i:i + 5])
        assert pos == list(range(pos[0], pos[0] + len(pos)))


def test_pack_then_train_on_cpu(image_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("WANDB_MODE", "disabled")
    cli.main(["pack", image_dir, "ds.tsrpack"])
    cli.main(["train", "--device", "cpu", "--train-dir", "ds.tsrpack",
              "--gen-blocks", "1", "--vgg-convs", "2", "--crop-size", "32",
              "--batch-size", "4", "--epochs", "1", "--pretrain-epochs", "1",
              "--shuffle-window", "4", "--data-workers", "2",
              "--skip-image-save", "--sync-saves"])
    for phase in ("psnr", "gan"):
        assert os.path.exists(f"esrgan-{phase}-latest.pth")


def test_loader_bench_reads_both_sources_cold(tmp_path):
    """``tools/bench_loader.py`` at a tiny size: four runs of a cold and
    a warm epoch, the same crops from the directory and the pack, the eviction's residue
    read back, the work directory removed."""
    from torchsr_tpu_torch.tools import bench_loader

    work = tmp_path / "work"
    out = bench_loader.main(["--images", "3", "--height", "130", "--width",
                             "140", "--work", str(work)])
    assert [r["source"] for r in out["runs"]] == [
        "directory", "pack", "pack", "directory"]
    assert out["same_crops"] and not work.exists()
    for r in out["runs"]:
        assert 0.0 <= r["resident_share_after_evict"] <= 1.0
        assert r["cold_s"] > 0 and r["warm_s"] > 0 and r["batches"] == 1
