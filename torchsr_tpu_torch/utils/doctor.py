"""``python -m torchsr_tpu_torch doctor``: environment and setup diagnostics.

The port of the JAX package's ``torchsr_tpu/utils/doctor.py``: versions,
the environment knobs the port reads, the dataset, checkpoint and
working-directory probes, and ``--json``.  Its device probes are the
port's own: torch and CUDA versions, the card's name and power limit,
whether ``nvcc`` is found, whether each kernel library of
``ops/_build.SIGNATURES`` is built and loads, and which RDB kernel
variant the knobs select for training and for inference, where the
kernels are built (``utils/compile_cache.py``), and, unless
``--no-device-check``, one tiny matmul on the card under a watchdog.
Every probe degrades to an ``error:`` string: a diagnostics tool must
not crash on the broken setup it exists to explain.  It builds nothing:
a library not built yet is reported as such (the first kernel call
builds it).

Only the CLI imports this module.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import threading
import time

# Every environment knob the port reads, with one-line meanings.
_KNOBS = {
    "TORCHSR_RDB_BWD": "RDB backward backend (pallas: the CUDA kernels; "
                       "xla: the plain PyTorch backward, for debugging)",
    "TORCHSR_RDB_EXT": "row-extended RDB kernels (B7/B8) on eligible shapes",
    "TORCHSR_RDB_ILV": "interleaved RDB forward (B6) where no backward "
                       "follows",
    "TORCHSR_VGG_WEIGHTS": "VGG19 weights for the perceptual loss",
    "TORCHSR_COMPILE_CACHE": "where the kernels are built (0: a fresh "
                             "temporary directory a process)",
    "TORCH_HOME": "torch hub cache searched for VGG19 weights",
    "CUDA_HOME": "CUDA toolkit whose nvcc builds the kernels",
    "CUDA_PATH": "CUDA toolkit (when CUDA_HOME is unset)",
    "CUDA_VISIBLE_DEVICES": "the cards this process sees",
}


def _error(e: Exception) -> str:
    return f"error: {type(e).__name__}: {e}"


def _versions() -> dict:
    from torchsr_tpu_torch.__version__ import VERSION

    out = {"torchsr_tpu_torch": VERSION,
           "python": platform.python_version()}
    for mod in ("torch", "numpy"):
        try:
            out[mod] = __import__(mod).__version__
        except Exception as e:  # pragma: no cover
            out[mod] = _error(e)
    return out


def _cuda() -> dict:
    """What torch sees of CUDA, and the card's name and power limit as
    ``nvidia-smi`` reports them."""
    try:
        import torch

        info: dict = {"torch_cuda": torch.version.cuda,
                      "available": torch.cuda.is_available()}
        if info["available"]:
            info["devices"] = [torch.cuda.get_device_name(i)
                               for i in range(torch.cuda.device_count())]
    except Exception as e:
        return {"available": False, "error": _error(e)}
    try:
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()
    except Exception as e:
        info["nvidia_smi"] = _error(e)
    return info


def _kernels() -> dict:
    """Each kernel library: built or not, and whether it loads and has
    the entry points ``SIGNATURES`` names."""
    try:
        import ctypes

        from torchsr_tpu_torch.ops import _build
        from torchsr_tpu_torch.utils.compile_cache import kernel_build_dir
    except Exception as e:
        return {"error": _error(e)}
    out = {}
    for name, symbols in _build.SIGNATURES.items():
        try:
            path = _build.library_path(name)
            if not path.exists():
                out[name] = (f"not built (built at first use into "
                             f"{kernel_build_dir()})")
                continue
            lib = ctypes.CDLL(str(path))
            missing = [s for s in symbols if not hasattr(lib, s)]
            out[name] = (f"error: {path.name} lacks {missing}" if missing
                         else f"built, loads: {path}")
        except Exception as e:
            out[name] = _error(e)
    return out


def _build_cache() -> dict:
    try:
        from torchsr_tpu_torch.utils.compile_cache import ENV, kernel_build_dir

        return {"dir": str(kernel_build_dir()),
                "from": f"{ENV}={os.environ[ENV]}" if os.environ.get(ENV)
                else "default"}
    except Exception as e:
        return {"error": _error(e)}


def _device_sanity(timeout_s: float = 120.0) -> dict:
    """One 256 x 256 matmul on the card and a scalar read back, timed,
    under a watchdog: a wedged card is reported as unresponsive instead
    of hanging the report (the probe thread cannot be interrupted)."""
    box: dict = {}

    def run() -> None:
        try:
            import torch

            if not torch.cuda.is_available():
                box.update(ok=False, error="no CUDA device "
                           "(torch.cuda.is_available() is False)")
                return
            t0 = time.perf_counter()
            x = torch.ones(256, 256, device="cuda")
            val = float((x @ x).mean())
            box.update(ok=abs(val - 256.0) < 1e-3, roundtrip_ms=round(
                (time.perf_counter() - t0) * 1e3, 1))
        except Exception as e:
            box.update(ok=False, error=_error(e))

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout_s)
    if thread.is_alive():
        return {"ok": False, "error": f"device unresponsive: probe still "
                                      f"blocked after {timeout_s:.0f}s"}
    return box


def _nvcc() -> str:
    try:
        from torchsr_tpu_torch.ops import _build

        return _build._nvcc()
    except Exception as e:
        return _error(e)


def _rdb_kernels() -> dict:
    """The RDB kernel variant the knobs select on each path
    (``ops/rdb.py`` ``_variant``)."""
    try:
        from torchsr_tpu_torch.ops import rdb
    except Exception as e:
        return {"error": _error(e)}
    gate = "where H*W <= 4096 and W % 16 == 0"
    slot_fwd = "rdb_fwd.cu (B1)"
    if rdb.EXT_KERNEL:
        fwd = f"rdb_ext.cu forward (B7) {gate}, else {slot_fwd}"
        bwd = "rdb_ext.cu backward (B8) after B7, else rdb_bwd.cu (B2)"
    else:
        fwd, bwd = slot_fwd, "rdb_bwd.cu (B2)"
    if rdb.BWD_XLA:
        bwd = "rdb_bwd_reference (plain PyTorch, no kernel)"
    infer = fwd
    if rdb.ILV_KERNEL:
        ilv = "rdb_ilv.cu (B6)"
        infer = (f"rdb_ext.cu forward (B7) {gate}, else {ilv}"
                 if rdb.EXT_KERNEL else ilv)
    return {
        "EXT_KERNEL": rdb.EXT_KERNEL, "ILV_KERNEL": rdb.ILV_KERNEL,
        "BWD_XLA": rdb.BWD_XLA,
        "training": f"forward {fwd}; backward {bwd}",
        "inference": infer,
    }


def _env_knobs() -> dict:
    return {
        k: {"value": os.environ.get(k), "meaning": v}
        for k, v in _KNOBS.items()
        if os.environ.get(k) is not None
    }


def _checkpoints(cwd: str) -> list[str]:
    names = []
    try:
        for f in sorted(os.listdir(cwd)):
            if f.endswith((".ckpt", ".pth", ".pt")):
                size = os.path.getsize(os.path.join(cwd, f))
                names.append(f"{f} ({size / 1e6:.1f} MB)")
    except Exception as e:
        names.append(_error(e))
    return names


def _dataset(train_dir: str | None) -> dict:
    if not train_dir:
        return {"skipped": "pass --train-dir to check a dataset"}
    try:
        from torchsr_tpu_torch.data.discovery import split_dataset
        from torchsr_tpu_torch.data.loader import dataset_source

        train, test = split_dataset(dataset_source(train_dir)[0])
        return {"path": train_dir, "train_images": len(train),
                "val_images": len(test)}
    except Exception as e:
        return {"path": train_dir, "error": _error(e)}


def _checkpoint_info(path: str | None) -> dict:
    """What is in a checkpoint file, read on the host: format, training
    metadata, and the architecture ``test``/``serve`` would size the
    generator to (``infer/runner.py`` ``load_trained_generator``)."""
    if not path:
        return {"skipped": "pass --checkpoint to inspect a file"}
    try:
        from argparse import Namespace

        from torchsr_tpu_torch.registry import select_test_model
        from torchsr_tpu_torch.utils.checkpoint import load_checkpoint

        ckpt = load_checkpoint(path)
        if ckpt is None:
            return {"path": path, "error": "file not found"}
        state = ckpt["state"]
        model = ("srgan" if any(k.startswith("conv_layers.") for k in state)
                 else "esrgan")
        gen = select_test_model(Namespace(model=model)).sized_to(
            state, device="meta")
        extras = ckpt.get("extra") or {}
        return {
            "path": path,
            "format": "torch .pth" if path.endswith((".pth", ".pt"))
            else "msgpack .ckpt",
            "epoch": ckpt.get("epoch"),
            "phase": ckpt.get("phase") or "(none)",
            "detected_model": model,
            "generator_params": int(sum(v.numel() for v in state.values())),
            "detected_blocks": len(gen.blocks),
            "detected_scale": gen.scale_factor,
            "training_state": sorted(extras) or
            "none (weights only: cross-phase or external checkpoint)",
        }
    except Exception as e:
        return {"path": path, "error": _error(e)}


def collect_report(train_dir: str | None = None,
                   checkpoint: str | None = None,
                   device_check: bool = True) -> dict:
    report = {
        "versions": _versions(),
        "platform": f"{platform.system()} {platform.release()}",
        "cuda": _cuda(),
        "nvcc": _nvcc(),
        "kernel_build_cache": _build_cache(),
        "kernels": _kernels(),
        "rdb_kernels": _rdb_kernels(),
        "env_knobs": _env_knobs() or {"none set": "defaults active"},
        "cwd_checkpoints": _checkpoints(os.getcwd())
        or ["none (train first, or pass --checkpoint)"],
        "dataset": _dataset(train_dir),
        "checkpoint": _checkpoint_info(checkpoint),
    }
    if device_check:
        report["device_sanity"] = _device_sanity()
    return report


def _print_tree(d: dict, indent: int = 0) -> None:
    pad = "  " * indent
    for key, val in d.items():
        if isinstance(val, dict):
            print(f"{pad}{key}:")
            _print_tree(val, indent + 1)
        elif isinstance(val, list):
            print(f"{pad}{key}:")
            for item in val:
                print(f"{pad}  - {item}")
        else:
            print(f"{pad}{key}: {val}")


def run_doctor(args) -> dict:
    report = collect_report(
        train_dir=getattr(args, "train_dir", None),
        checkpoint=getattr(args, "checkpoint", None),
        device_check=not getattr(args, "no_device_check", False),
    )
    if getattr(args, "json", False):
        print(json.dumps(report, indent=2, default=str))
    else:
        print("torchsr-tpu (PyTorch/CUDA) doctor")
        print("=" * 33)
        _print_tree(report)
        ok = (report["cuda"].get("available")
              and not str(report["nvcc"]).startswith("error")
              and report.get("device_sanity", {}).get("ok", True))
        print(f"\nverdict: {'OK' if ok else 'PROBLEMS'}")
    return report
