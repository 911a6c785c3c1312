"""Packed datasets: decode a directory once, read it from mmap after.

The port's own copy of ``torchsr_tpu/data/packed.py``, byte for byte the
same file format, so a pack written by either package reads in the
other.  ``python -m torchsr_tpu_torch pack dataset/ dataset.tsrpack``
decodes each image once (``utils.image_io.load_image``: RGB, uint8) and
stores its raw HWC bytes; ``--train-dir``, ``--eval-dir`` and ``eval``
then take the archive wherever they take a directory, and a "decode" is
an ``np.frombuffer`` view of the mapping.  Entries are written in
``discover_images`` order, so a pack and its directory give the same
split and the same batches for one seed.

Layout (one file, written as a stream, payloads 64-byte aligned):

    [8 B magic "TSRPACK1"]
    [image payloads: raw uint8 HWC bytes, each 64-byte aligned]
    [footer JSON: {"version": 1, "entries": [{name, h, w, offset}]}]
    [8 B little-endian footer length][8 B magic "TSRPACK1"]

The views ``PackedDataset.get`` returns are read-only: the loaders copy
the crops they slice from them into their batches (``np.stack``), and
keep no view in a decode cache.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import numpy as np

MAGIC = b"TSRPACK1"
_ALIGN = 64


def is_pack(path: str) -> bool:
    """Whether ``path`` is a pack (sniffed by its magic, not its
    extension)."""
    if not os.path.isfile(path):
        return False
    try:
        with open(path, "rb") as fh:
            return fh.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


def pack_dataset(src_dir: str, out_path: str, log=None) -> int:
    """Decode every supported image of ``src_dir`` into ``out_path``,
    in ``discover_images`` order, written to a temporary file and
    renamed; returns the image count."""
    from torchsr_tpu_torch.utils.image_io import discover_images, load_image

    paths = discover_images(src_dir)
    if not paths:
        raise ValueError(f"no supported images found in {src_dir!r} to pack")
    names = [os.path.basename(p) for p in paths]
    if len(set(names)) != len(names):
        raise ValueError("duplicate basenames across the source directory; "
                         "a pack addresses images by basename")
    entries = []
    tmp = out_path + ".tmp"
    try:
        with open(tmp, "wb") as fh:
            fh.write(MAGIC)
            for i, (path, name) in enumerate(zip(paths, names)):
                arr = np.ascontiguousarray(load_image(path))
                fh.write(b"\0" * ((-fh.tell()) % _ALIGN))
                entries.append({"name": name, "h": int(arr.shape[0]),
                                "w": int(arr.shape[1]),
                                "offset": fh.tell()})
                fh.write(arr.tobytes())
                if log and (i + 1) % 100 == 0:
                    log(f"packed {i + 1}/{len(paths)}")
            footer = json.dumps({"version": 1, "entries": entries}).encode()
            fh.write(footer)
            fh.write(struct.pack("<Q", len(footer)))
            fh.write(MAGIC)
        os.replace(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if log:
        size = os.path.getsize(out_path)
        log(f"packed {len(paths)} images ({size / 1e9:.2f} GB raw uint8) "
            f"into {out_path}")
    return len(paths)


class PackedDataset:
    """mmap-backed reader of a pack: ``names`` in pack order, ``get(name)``
    a read-only (H, W, 3) uint8 view."""

    def __init__(self, path: str) -> None:
        self.path = path
        tail = len(MAGIC) + 8
        with open(path, "rb") as fh:
            if fh.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path!r} is not a TSRPACK file")
            size = fh.seek(0, os.SEEK_END)
            if size < len(MAGIC) + tail:
                raise ValueError(f"{path!r} is truncated (no footer): "
                                 "re-run pack")
            fh.seek(-tail, os.SEEK_END)
            footer_len, = struct.unpack("<Q", fh.read(8))
            if fh.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path!r} is truncated (missing trailing "
                                 "magic): re-run pack")
            if footer_len > size - len(MAGIC) - tail:
                raise ValueError(f"{path!r} is truncated (footer length "
                                 f"{footer_len} exceeds the file): re-run "
                                 "pack")
            fh.seek(-(tail + footer_len), os.SEEK_END)
            footer = json.loads(fh.read(footer_len))
        if footer.get("version") != 1:
            raise ValueError(
                f"unsupported pack version {footer.get('version')!r}")
        self._entries = {e["name"]: e for e in footer["entries"]}
        self.names = [e["name"] for e in footer["entries"]]
        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)

    def __len__(self) -> int:
        return len(self.names)

    def get(self, name: str) -> np.ndarray:
        """The image as a read-only (H, W, 3) uint8 view of the mapping:
        a crop slices only the bytes it touches."""
        e = self._entries[name]
        arr = np.frombuffer(self._mm, np.uint8, count=e["h"] * e["w"] * 3,
                            offset=e["offset"])
        return arr.reshape(e["h"], e["w"], 3)

    def close(self) -> None:
        self._mm.close()
        self._file.close()
