"""The port's bench regression gate: run ``tools/bench.py`` on the card
and hold every metric against its floor in ``bench_expectations.json``
(beside this file).

    python -m torchsr_tpu_torch.tools.bench_regression           # run + check
    python -m torchsr_tpu_torch.tools.bench_regression --check out.txt

Floors are the port's own, from its card's steady state (the kept phase
of two bench runs, about 15% below it, as the JAX package's gate sets
its own); each entry records the card's name and power limit, the
commit and the date it was measured on.  An entry whose ``min`` is null
has its floor withheld (its ``withheld`` says why): the metric must
still be present.  A metric that is missing, or below its floor, fails
the gate (exit 1).  The card a line names is printed beside the card the
floors were measured on: floors compare like with like only there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
EXPECTATIONS = os.path.join(HERE, "bench_expectations.json")


def parse_metrics(text: str) -> dict:
    """Every bench line (a JSON object with a ``metric``) in ``text``,
    by metric name; the last line of a name wins."""
    metrics = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{") and '"metric"' in line:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            metrics[rec["metric"]] = rec
    return metrics


def load_floors(path: str = EXPECTATIONS) -> dict:
    with open(path) as fh:
        return {k: v for k, v in json.load(fh).items()
                if not k.startswith("_")}


def check(metrics: dict, floors: dict) -> tuple[bool, list]:
    """(passed, report lines) of ``metrics`` (``parse_metrics``) against
    ``floors`` (``load_floors``)."""
    ok, lines = True, []
    for name, spec in floors.items():
        rec = metrics.get(name)
        if rec is None:
            lines.append(f"MISSING {name} (floor {spec['min']})")
            ok = False
            continue
        got = rec["value"]
        card = f"{rec.get('device')}, {rec.get('power_limit_w')} W"
        if spec["min"] is None:
            lines.append(f"ok {name}: {got} (floor withheld: "
                         f"{spec['withheld']}) on {card}")
        elif got < spec["min"]:
            lines.append(f"REGRESSION {name}: {got} < floor {spec['min']} "
                         f"(steady state {spec['reference']} on "
                         f"{spec['device']}, {spec['power_limit_w']} W) "
                         f"on {card}")
            ok = False
        else:
            lines.append(f"ok {name}: {got} >= {spec['min']} on {card}")
    return ok, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--check", type=str, default=None,
                    help="Parse a saved bench output instead of running.")
    ap.add_argument("--expectations", type=str, default=EXPECTATIONS)
    args = ap.parse_args(argv)
    floors = load_floors(args.expectations)
    if args.check:
        with open(args.check) as fh:
            text = fh.read()
    else:
        proc = subprocess.run(
            [sys.executable, "-m", "torchsr_tpu_torch.tools.bench"],
            capture_output=True, text=True, cwd=ROOT)
        sys.stderr.write(proc.stderr[-4000:])
        text = proc.stdout
        print(text, end="")
    ok, lines = check(parse_metrics(text), floors)
    for line in lines:
        print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
