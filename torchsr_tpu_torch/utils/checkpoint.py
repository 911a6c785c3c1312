"""Checkpoints: the reference's ``.pth`` and the JAX package's ``.ckpt``.

A checkpoint is ``{"epoch", "phase", "state"}`` with the generator's
``state_dict`` under ``state``, the reference's contract; a training
checkpoint also holds the rest of the training state under ``extra``
(the discriminator's state_dict, the three optimizers' states, the
step counter and the best PSNR), so a resume is lossless.  ``.pth``
files are read and written with ``torch.save``/``torch.load``.
``.ckpt`` files are the JAX package's msgpack format (flax's encoding
of numpy arrays); they are read here, and their flax parameters are
converted to the port's ``state_dict``.  Names follow
``{model}-{phase}-{best,latest}`` in the working directory.
"""

from __future__ import annotations

import os
import threading
from typing import Any

import numpy as np
import torch

from torchsr_tpu_torch.models.torch_compat import (
    from_jax_variables,
    unwrap_state_dict,
)

# flax.serialization's msgpack extension codes for arrays and scalars
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(
    path: str, epoch: int, phase: str, state_dict: dict,
    extra: dict | None = None,
) -> None:
    """Atomically write ``{"epoch", "phase", "state"[, "extra"]}`` as a
    ``.pth``; tensors go to the CPU first."""
    payload = {
        "epoch": int(epoch),
        "phase": str(phase),
        "state": {k: v.detach().cpu() for k, v in state_dict.items()},
    }
    if extra is not None:
        payload["extra"] = _to_cpu(extra)
    # a unique tmp name: two writers of one path each replace atomically
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _msgpack_restore(blob: bytes) -> Any:
    try:
        import msgpack
    except ImportError as exc:
        raise ImportError(
            "reading a .ckpt checkpoint (the JAX package's msgpack "
            "format) needs the 'msgpack' package, which is not "
            "installed; install it, or load a .pth checkpoint"
        ) from exc

    def ext_hook(code: int, data: bytes):
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = msgpack.unpackb(data, raw=True)
            arr = np.frombuffer(buf, dtype=np.dtype(dtype.decode()))
            arr = arr.reshape(shape)
            return arr if code == _EXT_NDARRAY else arr[()]
        return msgpack.ExtType(code, data)

    return msgpack.unpackb(blob, ext_hook=ext_hook, raw=False)


def _load_torch(path: str) -> dict:
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state" in raw:
        state, epoch, phase = (
            raw["state"], raw.get("epoch", 1), raw.get("phase", "")
        )
    else:
        state, epoch, phase = raw, 1, ""
    out = {"epoch": int(epoch), "phase": str(phase),
           "state": unwrap_state_dict(state)}
    if isinstance(raw, dict) and "extra" in raw:
        out["extra"] = raw["extra"]
    return out


def load_checkpoint(path: str, model: str | None = None) -> dict | None:
    """Load a checkpoint as ``{"epoch", "phase", "state": state_dict}``
    (with ``extra`` where a ``.pth`` training checkpoint has it); None
    when the file does not exist.  ``model`` names the architecture
    (``esrgan`` or ``srgan``); a ``.ckpt``'s tree tells its own, so the
    name is only checked."""
    if model is not None and model.lower() not in ("esrgan", "srgan"):
        raise RuntimeError(
            f"{model} checkpoints are not supported: choose esrgan or "
            f"srgan"
        )
    if not path or not os.path.exists(path):
        return None
    if path.endswith((".pth", ".pt")):
        return _load_torch(path)
    with open(path, "rb") as fh:
        blob = fh.read()
    try:
        payload = _msgpack_restore(blob)
    except ValueError:
        # not msgpack: a torch pickle under a .ckpt name
        return _load_torch(path)
    return {
        "epoch": int(payload.get("epoch", 1)),
        "phase": str(payload.get("phase", "")),
        "state": from_jax_variables(payload["state"]),
    }


def find_checkpoint(*candidates: str) -> str | None:
    """First existing path among candidates; a ``.ckpt`` name also
    matches the ``.pth`` beside it, so reference files are picked up."""
    for cand in candidates:
        if not cand:
            continue
        if os.path.exists(cand):
            return cand
        if cand.endswith(".ckpt"):
            alt = cand[: -len(".ckpt")] + ".pth"
            if os.path.exists(alt):
                return alt
    return None
