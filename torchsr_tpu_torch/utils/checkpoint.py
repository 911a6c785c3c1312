"""Checkpoints: the reference's ``.pth`` and the JAX package's ``.ckpt``.

A checkpoint is ``{"epoch", "phase", "state"}`` with the generator's
``state_dict`` under ``state``, the reference's contract; a training
checkpoint also holds the rest of the training state under ``extra``
(the discriminator's state_dict, the three optimizers' states, the
step counter and the best PSNR), so a resume is lossless.  ``.pth``
files are read and written with ``torch.save``/``torch.load``.
``.ckpt`` files are the JAX package's msgpack format (flax's encoding
of numpy arrays); they are read here, and their flax parameters (and a
training checkpoint's extras) are converted to the port's.  An ESRGAN
``.pth`` in a public RRDBNet scheme (xinntao's, BasicSR's) is read under
the reference's keys (``models/torch_compat.py``).  Names follow
``{model}-{phase}-{best,latest}`` in the working directory.

A file is serialized in memory and written under a temporary name, then
renamed: the bytes do not depend on the temporary name, so two writes of
one state give one file.  ``AsyncCheckpointWriter`` moves the host copy
and the write off the training loop.
"""

from __future__ import annotations

import io
import os
import threading
from typing import Any

import numpy as np
import torch

from torchsr_tpu_torch.models.torch_compat import (
    canonical_esrgan_sd,
    from_jax_training_state,
    from_jax_variables,
    is_esrgan_sd,
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
    # serialized in memory: torch.save names the archive inside the file
    # after the file, and the temporary name must not reach the bytes
    buf = io.BytesIO()
    torch.save(payload, buf)
    # a unique tmp name: two writers of one path each replace atomically
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with open(tmp, "wb") as fh:
            fh.write(buf.getbuffer())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _snapshot(tree: Any) -> Any:
    """A copy of every tensor of ``tree`` (dicts, lists and tuples nest)
    on its own device, queued on the current stream."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    return tree


def _cuda_device(tree: Any) -> torch.device | None:
    """The CUDA device of the first CUDA tensor of ``tree``, if any."""
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.is_cuda else None
    values = (tree.values() if isinstance(tree, dict)
              else tree if isinstance(tree, (list, tuple)) else ())
    for v in values:
        dev = _cuda_device(v)
        if dev is not None:
            return dev
    return None


class AsyncCheckpointWriter:
    """Checkpoint writes that overlap training (the port of the JAX
    package's ``AsyncCheckpointWriter``).

    ``save()`` runs on the training thread and only takes a snapshot: a
    clone of every tensor on the current stream, and on CUDA an event
    recorded after the clones.  It never rebinds or touches the live
    tensors again, which the trainer's CUDA graphs and fused optimizers
    update in place at fixed addresses.  One worker thread takes the
    jobs in order: it waits for the event on a stream of its own, copies
    the snapshot to the host, serializes it and writes it with an atomic
    rename (``save_checkpoint``, so the bytes equal a synchronous
    save's).

    - A newer save of a path replaces an older one that has not
      started: pending memory is one snapshot a path and the one in
      flight.
    - Paths are written first in, first out.
    - ``wait()`` blocks until everything enqueued is on disk; the
      trainer calls it before it reads a checkpoint file, at the end of
      each phase, and on preemption.
    - An error is sticky: a failed write raises at the next ``save()``
      or ``wait()``.
    - ``close()`` drains and ends the worker; a later ``save()`` starts
      another.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._pending: dict[str, tuple] = {}
        self._order: list[str] = []
        self._inflight = 0
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None
        self._closing = False
        self._stream = None  # the worker's CUDA stream, made at first use

    def _check_error(self) -> None:
        with self._cond:
            err = self._error
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

    def save(self, path: str, epoch: int, phase: str, state_dict: dict,
             extra: dict | None = None) -> None:
        """Snapshot ``state_dict`` and ``extra`` and enqueue the write of
        ``path`` (``save_checkpoint``'s arguments)."""
        self._check_error()
        snap = _snapshot({"state": state_dict, "extra": extra})
        device = _cuda_device(snap)
        event = None
        if device is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        with self._cond:
            if path not in self._pending:
                self._order.append(path)
            self._pending[path] = (int(epoch), str(phase), snap, device,
                                   event)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="ckpt-writer", daemon=True)
                self._thread.start()
            self._cond.notify_all()

    def _to_host(self, snap: dict, device, event) -> dict:
        if device is None:
            return snap
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(event)
            host = _to_cpu(snap)
        # the clones may be freed only after the copies read them
        self._stream.synchronize()
        return host

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._order and not self._closing:
                    self._cond.wait()
                if not self._order:
                    return
                path = self._order.pop(0)
                job = self._pending.pop(path)
                self._inflight += 1
            epoch, phase, snap, device, event = job
            del job
            try:
                host = self._to_host(snap, device, event)
                del snap
                save_checkpoint(path, epoch, phase, host["state"],
                                extra=host["extra"])
            except BaseException as exc:  # raised at the next save/wait
                with self._cond:
                    if self._error is None:
                        self._error = exc
            finally:
                snap = host = None
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def pending(self) -> int:
        """Writes enqueued or in flight."""
        with self._cond:
            return len(self._order) + self._inflight

    def wait(self, log=None) -> None:
        """Block until every enqueued checkpoint is on disk; ``log`` (a
        callable) hears of a wait longer than two seconds."""
        logged = False
        with self._cond:
            while self._order or self._inflight:
                self._cond.wait(timeout=2.0)
                if log is not None and not logged and (self._order
                                                       or self._inflight):
                    log(f"Draining {len(self._order) + self._inflight} "
                        "pending checkpoint write(s)")
                    logged = True
        self._check_error()

    def close(self) -> None:
        """Drain (``wait``) and end the worker thread."""
        try:
            self.wait()
        finally:
            with self._cond:
                thread, self._thread = self._thread, None
                self._closing = thread is not None
                self._cond.notify_all()
            if thread is not None:
                thread.join()
            with self._cond:
                self._closing = False


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
    state = unwrap_state_dict(state)
    if is_esrgan_sd(state):
        state = canonical_esrgan_sd(state)
    out = {"epoch": int(epoch), "phase": str(phase), "state": state}
    if isinstance(raw, dict) and "extra" in raw:
        out["extra"] = raw["extra"]
    return out


def load_checkpoint(path: str, model: str | None = None) -> dict | None:
    """Load a checkpoint as ``{"epoch", "phase", "state": state_dict}``
    (with ``extra`` where a training checkpoint has it, a ``.ckpt``'s
    converted by ``from_jax_training_state``); None when the file does
    not exist.  ``model`` names the architecture (``esrgan``, ``srgan``
    or ``hat``); the keys or the tree tell their own (an ESRGAN's name
    its RRDBs, in any scheme), so the name is only checked."""
    if model is not None and model.lower() not in ("esrgan", "srgan",
                                                   "hat"):
        raise RuntimeError(
            f"{model} checkpoints are not supported: choose esrgan, "
            f"srgan or hat"
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
    out = {
        "epoch": int(payload.get("epoch", 1)),
        "phase": str(payload.get("phase", "")),
        "state": from_jax_variables(payload["state"]),
    }
    if payload.get("extra"):
        out["extra"] = from_jax_training_state(
            payload["extra"], payload["state"].get("batch_stats", {}))
    return out


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
