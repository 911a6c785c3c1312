"""Package rules of the PyTorch/CUDA port: no JAX, no JAX package.

``torchsr_tpu_torch`` and ``chip_smoke.py`` import torch, numpy and the
standard library only.  The check runs in a fresh interpreter, since
this test process already imports JAX (tests/conftest.py), and again
as a scan of every import statement.  Note that the port's own name
starts with ``torchsr_tpu``: only ``torchsr_tpu`` and ``torchsr_tpu.*``
are the JAX package.
"""

import ast
import re
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


# a path into the JAX package or the repo's pre-port tools: the
# component "tools" or "torchsr_tpu" right under the repository's root
# (a name ROOT or REPO, or an expression of __file__), or a string
# starting with "tools/" or "torchsr_tpu/"
_OUTSIDE = ("tools", "torchsr_tpu")
_PREFIX = re.compile(r"^(tools|torchsr_tpu)/")


def _repo_base(node) -> bool:
    return ((isinstance(node, ast.Name) and node.id in ("ROOT", "REPO"))
            or "__file__" in ast.unparse(node))


def _string(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _outside_parts(node) -> list:
    """The parts of a path ``node`` builds (an ``os.path.join`` / ``Path``
    call, or a ``/``) that lead outside the port."""
    if isinstance(node, ast.Call) and ast.unparse(node.func) in (
            "os.path.join", "join", "Path", "pathlib.Path"):
        operands = list(node.args)
    elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        operands = [node.left, node.right]
    else:
        return []
    parts = [p for p in map(_string, operands) if p and _PREFIX.match(p)]
    if (len(operands) > 1 and _repo_base(operands[0])
            and _string(operands[1]) in _OUTSIDE):
        parts.append(_string(operands[1]))
    return parts


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_name_no_path_outside_the_port(path):
    """No module of the port, nor ``chip_smoke.py``, builds a path into
    the JAX package or the repo's ``tools/`` (the port keeps its own
    copy of what it runs, e.g. ``tools/make_quality_dataset.py``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        parts = _outside_parts(node)
        assert not parts, f"{path}:{node.lineno} builds a path into {parts}"


@pytest.mark.parametrize("src,outside", [
    ('os.path.join(ROOT, "tools", "make_quality_dataset.py")', True),
    ('ROOT / "torchsr_tpu" / "ops"', True),
    ('Path("tools/metrics_summary.py")', True),
    ('os.path.join(os.path.dirname(__file__), "torchsr_tpu")', True),
    ('os.path.join(ROOT, "media", "waterfalls-low-res.png")', False),
    ('ROOT / "torchsr_tpu_torch" / "tools"', False),
    ('os.path.join(home, ".cache", "torchsr_tpu", "vgg19.ckpt")', False),
])
def test_outside_path_scan_sees_the_old_corpus_call(src, outside):
    """The scan flags the form ``quality_run`` used before it had its own
    corpus script (the first case) and other joins out of the port,
    and not the port's own paths or a user cache's."""
    tree = ast.parse(src, mode="eval")
    assert any(_outside_parts(n) for n in ast.walk(tree)) == outside
