"""On the card: each cell of BENCHMARK.json runs end to end in its own
process with a short window and comes out correct, with the benchmark's
result line.  Skips without a CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from port_bench import harness

CELLS = [c["name"] for c in harness.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(card, name):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", name,
         "--seed", "3000000019", "--seconds", "3", "--trace", "0"],
        cwd=harness.CHECKOUT, capture_output=True, text=True, timeout=900,
        check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
