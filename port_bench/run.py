"""Run one cell of the benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell by name (``workloads/<cell>.json``), builds the program
on the card from the seed, warms every shape its traffic uses (set-up,
timed as ``setup_s`` from the start of this process), measures for
``--seconds``, checks what the measured window produced against the
plain reference, and prints one JSON line last on standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and ``checks``: each number compared
beside its limit), with the same checks as the last lines of standard
error.  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer ones, from a profiled slice after the window.  Exits
non-zero, printing no result, without a CUDA card (or with fewer than
the cell asks for), and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from port_bench import harness  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(run: "harness.Run") -> dict:
    """Drive the cell and return its result line (no chip check: the
    caller has chosen the device)."""
    outcome = harness.driver(run.cell["driver"]).run(run)
    for note in outcome.notes:
        harness.log(note)
    correct = harness.judge(outcome.checks) and outcome.failed == 0
    return harness.result_line(run, outcome, correct)


def main(argv=None) -> int:
    args = parse(argv)
    harness.set_environment()
    import torch

    harness.log(f"setup: torch imported at "
                f"{time.perf_counter() - T_START:.3f} s")
    if not torch.cuda.is_available():
        harness.log("port_bench: no CUDA device (torch.cuda.is_available() "
                    "is False); nothing measured")
        return 2
    run = harness.Run.of(args.workload, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace),
                         device=torch.device("cuda", 0), t_start=T_START)
    chips = int(run.cell.get("chips", 1))
    if torch.cuda.device_count() < chips:
        harness.log(f"port_bench: {run.name} needs {chips} cards, "
                    f"{torch.cuda.device_count()} visible; nothing measured")
        return 2
    harness.log(f"card: {harness.card_line(run.device)}")
    line = execute(run)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"port_bench: the run loaded {', '.join(found)} "
                    f"(JAX or the JAX package); no result")
        return 3
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        harness.log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
