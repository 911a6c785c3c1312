"""What every cell's run shares: finding the cell's files by name, the
run's environment, the device's description, the result line and the
check that no JAX was loaded."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "torchsr_tpu")


def set_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout (so
    that only a cell's first run in a checkout builds), no metrics
    sink, no JAX pulled in by a library.  Before the port is
    imported."""
    build = CHECKOUT / "build"
    os.environ["TORCHSR_COMPILE_CACHE"] = str(build / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["WANDB_MODE"] = "disabled"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(*parts: str) -> dict:
    return json.loads(HERE.joinpath(*parts).read_text())


def benchmark() -> dict | None:
    path = CHECKOUT / "BENCHMARK.json"
    return json.loads(path.read_text()) if path.is_file() else None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Run:
    """One run of one cell."""

    name: str
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    cell: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)
    hooks: dict = field(default_factory=dict)

    @classmethod
    def of(cls, name: str, **kw) -> "Run":
        run = cls(name=name, **kw)
        run.cell = load_json("workloads", f"{name}.json")
        run.config = load_json("configs", f"{run.cell['config']}.json")
        run.traffic = load_json("traffic", f"{run.cell['traffic']}.json")
        for key, value in run.hooks.get("overrides", {}).items():
            getattr(run, key).update(value)
        return run


@dataclass
class Outcome:
    """What a driver hands back to the harness."""

    setup_s: float
    end_to_end: dict
    window: dict
    checks: list
    attempted: int
    failed: int
    memory_peak_bytes: int
    slice: dict | None = None
    notes: list = field(default_factory=list)


def driver(kind: str):
    return importlib.import_module(f"port_bench.drivers.{kind}")


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(run: Run) -> tuple[dict, dict]:
    """(end-to-end, per-layer) metric specs of BENCHMARK.json that apply
    to the cell: those whose ``workloads`` name it, and those without
    ``workloads`` that move an end-to-end metric the cell reports."""
    bench = benchmark()
    if not bench or all(w["name"] != run.name for w in bench["workloads"]):
        raise ValueError(f"{run.name} is not a workload of BENCHMARK.json")
    e2e = {m["name"]: m for m in bench["end_to_end"]
           if run.name in m.get("workloads", [run.name])}
    per = {m["name"]: m for m in bench["per_layer"]
           if run.name in m.get("workloads", [run.name])
           and ("workloads" in m or m["moves"] in e2e)}
    return e2e, per


def device_info(run: Run, memory_peak: int, sliced: dict | None) -> dict:
    import torch

    out = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": int(run.cell.get("chips", 1)),
           "memory_peak_bytes": int(memory_peak)}
    if run.trace:
        out["busy_s"] = sliced["busy_s"] if sliced else None
        out["window_s"] = sliced["window_s"] if sliced else None
    return out


def card_line(device) -> str:
    """The card's name, power limit and clocks, from ``nvidia-smi``."""
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--id={device.index or 0}",
             "--query-gpu=name,power.limit,clocks.max.sm,driver_version",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False)
        return res.stdout.strip() or res.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(run: Run, outcome: Outcome, correct: bool) -> dict:
    """The result line: ``--trace 0`` carries the cell's
    end-to-end metrics, ``--trace 1`` its per-layer ones; ``checks``
    (each number compared beside its limit) comes last."""
    e2e_specs, per_specs = cell_metrics(run)
    metrics = {}
    if not run.trace:
        values = dict(outcome.end_to_end)
        values["setup_s"] = (outcome.setup_s, "s")
        for name, spec in e2e_specs.items():
            if name in values:
                metrics[name] = {"value": values[name][0],
                                 "unit": spec.get("unit", values[name][1])}
    else:
        ctx = {"run": run, "window": outcome.window, "slice": outcome.slice}
        for name, spec in per_specs.items():
            value = metric_reader(name).read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": spec["unit"]}
    line = {"correct": bool(correct), "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics,
            "device": device_info(run, outcome.memory_peak_bytes,
                                  outcome.slice)}
    if run.trace and outcome.slice:
        line["breakdown"] = {"device_ops": outcome.slice["device_ops"],
                             "idle_gaps": outcome.slice["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in outcome.checks}
    return line


def judge(checks: list) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"] for c in checks)


def checks_from(values: dict, limits: dict) -> list:
    """One check a limit of the cell: the number compared and its
    limit (a missing number reads as infinite)."""
    return [{"name": k, "value": float(values.get(k, float("inf"))),
             "limit": float(v)} for k, v in limits.items()]
