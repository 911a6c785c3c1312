"""Host time of a training epoch's loading: a PNG directory against its pack.

Builds a DIV2K-shaped training set (by default 800 images of 1356 x
2040, the DIV2K training split's count and its common HR size) of
seeded smooth content with noise (``png_gb`` against ``pack_gb`` in
the result gives its compression); packs it with ``data.packed.pack_dataset``; then
times ``TrainLoader.epoch`` (crop 128, batch 16, 16 workers: ``train``'s
defaults) from each source in the order directory, pack, pack,
directory.  Each measurement starts cold: every file of the source is
synced and dropped from the page cache (``posix_fadvise(DONTNEED)``),
the share of its pages still resident is read back with ``mincore``
and printed (a file system that ignores the advice shows there), and a
fresh loader has decoded nothing.  The same loader's second epoch is
the warm time (the directory's decode cache; the pack's page cache).

Usage: python -m torchsr_tpu_torch.tools.bench_loader [--images 800]
       [--height 1356] [--width 2040] [--work build/loader_bench]
       [--out result.json]

One JSON object on the last line; the card line (nvidia-smi) before
it.  The work directory is deleted at the end.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from torchsr_tpu_torch.data.discovery import discover_images
from torchsr_tpu_torch.data.loader import TrainLoader
from torchsr_tpu_torch.data.packed import PackedDataset, pack_dataset
from torchsr_tpu_torch.tools.quality_run import card

CROP, BATCH, WORKERS = 128, 16, 16
_PAGE = os.sysconf("SC_PAGE_SIZE")


def _write_image(job: tuple) -> int:
    """One seeded image: a smooth field (a coarse grid upsampled) plus
    noise of sigma 6, written as a PNG; returns its bytes on disk."""
    from PIL import Image

    path, h, w, seed = job
    rng = np.random.default_rng(seed)
    coarse = rng.random((h // 64 + 2, w // 64 + 2, 3), np.float32) * 255
    yi = np.linspace(0, coarse.shape[0] - 1.001, h)
    xi = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0, x0 = yi.astype(int), xi.astype(int)
    fy, fx = (yi - y0)[:, None, None], (xi - x0)[None, :, None]
    top = coarse[y0][:, x0] * (1 - fx) + coarse[y0][:, x0 + 1] * fx
    bot = coarse[y0 + 1][:, x0] * (1 - fx) + coarse[y0 + 1][:, x0 + 1] * fx
    img = top * (1 - fy) + bot * fy + rng.normal(0, 6, (h, w, 3))
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        path, compress_level=1)
    return os.path.getsize(path)


def _libc():
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long)
    libc.munmap.argtypes = (ctypes.c_void_p, ctypes.c_size_t)
    libc.mincore.argtypes = (ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.c_void_p)
    return libc


def _resident_pages(libc, path: str) -> tuple[int, int]:
    """(pages of ``path`` in the page cache, pages of the file)."""
    size = os.path.getsize(path)
    pages = -(-size // _PAGE)
    if size == 0:
        return 0, 0
    fd = os.open(path, os.O_RDONLY)
    try:
        addr = libc.mmap(None, size, 1, 1, fd, 0)  # PROT_READ, MAP_SHARED
        if addr in (None, ctypes.c_void_p(-1).value):
            raise OSError(ctypes.get_errno(), f"mmap of {path}")
        try:
            vec = (ctypes.c_ubyte * pages)()
            if libc.mincore(addr, size, vec) != 0:
                raise OSError(ctypes.get_errno(), f"mincore of {path}")
            return sum(b & 1 for b in vec), pages
        finally:
            libc.munmap(addr, size)
    finally:
        os.close(fd)


def evict(files: list[str], libc) -> float:
    """Sync and drop ``files`` from the page cache; returns the share
    of their pages still resident afterwards."""
    resident = total = 0
    for path in files:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
        r, t = _resident_pages(libc, path)
        resident, total = resident + r, total + t
    return resident / max(1, total)


def _epochs(source: str, files: list[str], libc) -> dict:
    """A cold first epoch and a warm second one from ``source``."""
    resident = evict(files, libc)
    pack = PackedDataset(source) if source.endswith(".tsrpack") else None
    loader = TrainLoader(pack.names if pack else discover_images(source),
                         BATCH, CROP, workers=WORKERS, seed=0,
                         reader=pack.get if pack else None)
    times, checksum = [], 0
    for epoch in (0, 1):
        t0 = time.perf_counter()
        for crops, _ in loader.epoch(epoch):
            checksum += int(crops[:, 0, 0].sum())
        times.append(time.perf_counter() - t0)
    if pack:
        pack.close()
    return {"resident_share_after_evict": resident, "cold_s": times[0],
            "warm_s": times[1], "batches": loader.batches_per_epoch,
            "checksum": checksum}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--images", type=int, default=800)
    parser.add_argument("--height", type=int, default=1356)
    parser.add_argument("--width", type=int, default=2040)
    parser.add_argument("--work", default=os.path.join("build",
                                                       "loader_bench"))
    parser.add_argument("--out", help="also write the result here")
    args = parser.parse_args(argv)
    work = Path(args.work)
    raw = args.images * args.height * args.width * 3
    free = shutil.disk_usage(work.parent if work.parent.exists() else ".")
    if free.free < 2.5 * raw:
        raise SystemExit(f"{free.free / 1e9:.1f} GB free; the set and its "
                         f"pack need about {2.5 * raw / 1e9:.1f} GB")
    shutil.rmtree(work, ignore_errors=True)
    (work / "png").mkdir(parents=True)
    libc = _libc()
    try:
        t0 = time.perf_counter()
        jobs = [(str(work / "png" / f"{i:04d}.png"), args.height,
                 args.width, i) for i in range(args.images)]
        with ProcessPoolExecutor(os.cpu_count()) as pool:
            png_bytes = sum(pool.map(_write_image, jobs, chunksize=8))
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pack = str(work / "train.tsrpack")
        pack_dataset(str(work / "png"), pack)
        pack_s = time.perf_counter() - t0
        pngs = [job[0] for job in jobs]
        runs = []
        for name in ("directory", "pack", "pack", "directory"):
            src, files = ((str(work / "png"), pngs) if name == "directory"
                          else (pack, [pack]))
            runs.append({"source": name, **_epochs(src, files, libc)})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sums = {r["checksum"] for r in runs}
    result = {
        "card": card(), "cpus": os.cpu_count(), "images": args.images,
        "hw": [args.height, args.width], "crop": CROP, "batch": BATCH,
        "workers": WORKERS, "png_gb": png_bytes / 1e9, "pack_gb": raw / 1e9,
        "build_s": build_s, "pack_s": pack_s, "runs": runs,
        "same_crops": len(sums) == 1,
    }
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(result["card"])
    print(json.dumps(result))
    if not result["same_crops"]:
        raise SystemExit("the directory and the pack gave other crops")
    return result


if __name__ == "__main__":
    main()
