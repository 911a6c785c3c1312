"""Where the hand-written CUDA kernels are built: the port's build cache.

The JAX package keeps a persistent XLA compilation cache
(``torchsr_tpu/utils/compile_cache.py``); the port's cold-start cost is
instead ``nvcc``, one shared library a kernel source, named by a hash of
the source and flags (``ops/_build.py``), so a cache directory is safe
to share between checkouts and versions.  ``kernel_build_dir`` resolves
it:

- ``TORCHSR_COMPILE_CACHE=<dir>``: that directory;
- ``TORCHSR_COMPILE_CACHE=0``: a fresh temporary directory for this
  process (every kernel is built again);
- in a checkout (a ``chip_smoke.py`` beside the package): its
  ``build/kernels/``, ignored by git;
- in an installed package: ``~/.cache/torchsr_tpu_torch/kernels``.
"""

from __future__ import annotations

import functools
import os
import tempfile
from pathlib import Path

ENV = "TORCHSR_COMPILE_CACHE"
PACKAGE_ROOT = Path(__file__).resolve().parents[1]


@functools.cache
def _fresh_dir() -> Path:
    return Path(tempfile.mkdtemp(prefix="torchsr_kernels_"))


def kernel_build_dir(package_root: Path = PACKAGE_ROOT) -> Path:
    """The directory the kernel libraries are built into and loaded
    from (module docstring); not created here."""
    env = os.environ.get(ENV)
    if env == "0":
        return _fresh_dir()
    if env:
        return Path(env).expanduser()
    checkout = package_root.parent
    if (checkout / "chip_smoke.py").is_file():
        return checkout / "build" / "kernels"
    return Path.home() / ".cache" / "torchsr_tpu_torch" / "kernels"
