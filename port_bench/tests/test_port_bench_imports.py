"""Nothing under ``port_bench/`` imports JAX or the JAX package
``torchsr_tpu``, compared by whole top-level module name (the port,
``torchsr_tpu_torch``, begins with the JAX package's name), and the
plain reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness

ROOT = Path(harness.__file__).resolve().parent
FILES = sorted(ROOT.rglob("*.py"))


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not imported_tops(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted((ROOT / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = imported_tops(path)
    assert "torchsr_tpu_torch" not in tops
    assert tops <= {"__future__", "contextlib", "importlib", "math", "numpy",
                    "torch", "port_bench"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "torchsr_tpu_torch_probe", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "torchsr_tpu.models", object())
    assert harness.forbidden_modules() == ["jax", "torchsr_tpu"]


def test_a_run_process_loads_no_jax():
    code = ("import sys, port_bench.run, port_bench.control, "
            "port_bench.drivers.serve, port_bench.drivers.train, "
            "torchsr_tpu_torch.train.trainer, torchsr_tpu_torch.infer.server;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'torchsr_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT.parent, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
