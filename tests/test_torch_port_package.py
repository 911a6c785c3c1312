"""Package rules of the PyTorch/CUDA port: no JAX, no JAX package.

``torchsr_tpu_torch`` and ``chip_smoke.py`` import torch, numpy and the
standard library only.  The check runs in a fresh interpreter, since
this test process already imports JAX (tests/conftest.py), and again
as a scan of every import statement.  Note that the port's own name
starts with ``torchsr_tpu``: only ``torchsr_tpu`` and ``torchsr_tpu.*``
are the JAX package.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "torchsr_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "torchsr_tpu")


def test_import_pulls_in_no_jax():
    modules = sorted(
        "torchsr_tpu_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py")
        if p.name not in ("__init__.py", "__main__.py")
    )
    # chip_smoke.py is imported as a module too: its main() is guarded
    code = (
        "import sys, importlib, importlib.util\n"
        "import torchsr_tpu_torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{str(ROOT / 'chip_smoke.py')!r})\n"
        "smoke = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(smoke)\n"
        "assert callable(smoke.main)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'torchsr_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "torchsr_tpu_torch.infer.server" in modules
    assert {"torchsr_tpu_torch.data.synthetic",
            "torchsr_tpu_torch.train.graphs",
            "torchsr_tpu_torch.utils.profiling",
            "torchsr_tpu_torch.tools.bench",
            "torchsr_tpu_torch.tools.profile_gan_step",
            "torchsr_tpu_torch.tools.profile_pretrain",
            "torchsr_tpu_torch.tools.sweep_esrgan_batch",
            "torchsr_tpu_torch.infer.serving",
            "torchsr_tpu_torch.infer.batching",
            "torchsr_tpu_torch.tools.profile_infer",
            "torchsr_tpu_torch.tools.bench_inference",
            "torchsr_tpu_torch.tools.bench_batching",
            "torchsr_tpu_torch.tools.bench_serve_http",
            "torchsr_tpu_torch.tools.bench_regression"} <= set(modules)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert not _forbidden(name), f"{path}:{node.lineno} {name}"
