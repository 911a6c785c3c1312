"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled at first
use with ``nvcc`` for ``sm_90a`` into a shared library in the build
cache (``kernel_build_dir()`` of ``utils/compile_cache.py``: the
checkout's ``build/kernels/``, ignored by git, or where
``TORCHSR_COMPILE_CACHE`` points),
named by a hash of the source and flags so an edited source rebuilds,
and loaded with ``ctypes``.  Tensors
cross as ``data_ptr()`` integers and the stream as
``torch.cuda.current_stream().cuda_stream``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from torchsr_tpu_torch.utils import trace
from torchsr_tpu_torch.utils.compile_cache import kernel_build_dir

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# C signatures of each library's entry points: name -> (restype, argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The bf16 block backward's one entry (rdb_bwd.cu, rdb_ext.cu): g, feat,
# the kernels' pointer and stride arrays, w_f32, dy, dx, four scratch and
# output buffers, dw, db, B, H, W, scale, nblocks, P, the three grids,
# device, stream.
_BWD_BF16 = (_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
             _I, _I, _I, _I, _I, _I, _P)
# The f32 block backward's one entry (rdb_bwd.cu, rdb_ext.cu): as
# _BWD_BF16 without w_f32 (the kernels are f32), nb_dy for nblocks.
_BWD_TF32 = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
             _I, _I, _I, _I, _I, _I, _P)
# The bf16 block forward's one entry (rdb_fwd.cu, rdb_ext.cu, rdb_ilv.cu):
# x, feat (rdb_ilv.cu: the interleaved buffer),
# out, the kernels' pointer and stride arrays, w_f32, the biases' pointer
# array, the packed-weight scratch, B, H, W, scale, device, stream.
_FWD_BF16 = (_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _I, _P)
# The f32 block forward's one entry (rdb_fwd.cu, rdb_ext.cu, rdb_ilv.cu):
# as _FWD_BF16 without w_f32 (the kernels are f32).
_FWD_TF32 = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P)
SIGNATURES = {
    "rdb_fwd": {
        "rdb_fwd_bf16_launch": (_I, _FWD_BF16),
        "rdb_fwd_bf16_schedule": (_I, (_I, _I, _I, _P)),
        "rdb_fwd_tf32_launch": (_I, _FWD_TF32),
        "rdb_fwd_tf32_schedule": (_I, (_I, _I, _I, _P)),
        "rdb_error_string": (ctypes.c_char_p, (_I,)),
    },
    "rdb_bwd": {
        "rdb_bwd_bf16_launch": (_I, _BWD_BF16),
        "rdb_bwd_tf32_launch": (_I, _BWD_TF32),
        "rdb_bwd_tf32_schedule": (_I, (_I, _I, _I, _P)),
        "rdb_bwd_error_string": (ctypes.c_char_p, (_I,)),
    },
    "rdb_ext": {
        "rdb_ext_fwd_bf16_launch": (_I, _FWD_BF16),
        "rdb_ext_fwd_tf32_launch": (_I, _FWD_TF32),
        "rdb_ext_bwd_bf16_launch": (_I, _BWD_BF16),
        "rdb_ext_bwd_tf32_launch": (_I, _BWD_TF32),
        "rdb_ext_error_string": (ctypes.c_char_p, (_I,)),
    },
    "rdb_ilv": {
        "rdb_ilv_bf16_launch": (_I, _FWD_BF16),
        "rdb_ilv_bf16_schedule": (_I, (_I, _I, _I, _P)),
        "rdb_ilv_tf32_launch": (_I, _FWD_TF32),
        "rdb_ilv_tf32_schedule": (_I, (_I, _I, _I, _P)),
        "rdb_ilv_error_string": (ctypes.c_char_p, (_I,)),
    },
    "pair_synth": {
        "pair_synth_launch": (
            _I, (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P)
        ),
        "pair_synth_error_string": (ctypes.c_char_p, (_I,)),
    },
    "bn_act": {
        "bn_act_fwd_launch": (
            _I, (_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                 _I, _I, _I, _F, _F, _I, _P)
        ),
        "bn_act_bwd_launch": (
            _I, (_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                 _I, _I, _I, _I, _P)
        ),
        "bn_act_error_string": (ctypes.c_char_p, (_I,)),
    },
    "window_attn": {
        "window_attn_launch": (
            _I, (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P)
        ),
        "window_attn_error_string": (ctypes.c_char_p, (_I,)),
    },
    "add_ln": {
        "add_ln_launch": (
            _I, (_P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _F, _I, _I, _I, _P)
        ),
        "add_ln_error_string": (ctypes.c_char_p, (_I,)),
    },
    "pair_conv": {
        "pair_conv_launch": (
            _I, (_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
        ),
        "pair_conv_wgrad_launch": (
            _I, (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)
        ),
        "pair_conv_reduce_launch": (
            _I, (_P, _I, _I, _P, _I, _I, _P, _P, _I, _P)
        ),
        "pair_conv_error_string": (ctypes.c_char_p, (_I,)),
    },
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        Path(cuda_home) / "bin" / "nvcc" if cuda_home else None,
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand is not None and cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA toolkit is needed to build the kernels"
        )
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to; the hash covers the source,
    the shared headers (``csrc/*.cuh``) and the flags."""
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources)
        + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return kernel_build_dir() / f"lib{name}-{digest}.so"


def build_all(names=None) -> dict:
    """Compile every ``csrc/<name>.cu`` (all of ``SIGNATURES`` by
    default) whose library does not exist yet, one ``nvcc`` per source,
    all started together, each counted in the process counter
    ``kernel_builds`` (``utils/trace.py``).  Returns ``{name:
    {"seconds", "ptxas"}}`` for the sources built now (``ptxas`` is the
    compiler's register/spill report, with its warnings that it
    serialized ``wgmma``s: C75xx).
    Raises with the compiler's output when a build fails."""
    names = list(SIGNATURES if names is None else names)
    kernel_build_dir().mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        trace.count("kernel_builds")
        started[name] = (proc, tmp, out, time.perf_counter())
    built, failed = {}, []
    for name, (proc, tmp, out, t0) in started.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
        built[name] = {
            "seconds": time.perf_counter() - t0,
            "ptxas": [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln or "(C75" in ln],
        }
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per
    process."""
    build_all([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib
