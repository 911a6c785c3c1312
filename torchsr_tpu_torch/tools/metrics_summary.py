#!/usr/bin/env python
"""Summarize a ``train --metrics-file`` JSONL into per-key statistics.

The port's counterpart of the JAX package's tool: the port's trainer
writes the same records (a ``{"config": ...}`` header line, then one
``{"step": ..., key: value}`` line per logged step), and this tool
answers the usual questions — did PSNR rise, where is the best epoch,
what did the loss curve do — with the same table:

    python -m torchsr_tpu_torch.tools.metrics_summary curves.jsonl
    python -m torchsr_tpu_torch.tools.metrics_summary curves.jsonl \
        --csv curves.csv

``--csv`` also flattens the records into one row per step for external
plotting (a column per metric key, blank where a step didn't log it).
"""

from __future__ import annotations

import argparse
import json
import sys


def load_records(path: str) -> tuple[dict, list[dict]]:
    """Return (config, metric records) from a metrics JSONL file."""
    config: dict = {}
    records: list[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if "config" in rec and "step" not in rec:
                config = rec["config"]  # last header wins across resumes
            else:
                records.append(rec)
    return config, records


def summarize(records: list[dict]) -> dict[str, dict]:
    """Per-key {count, first, last, min, max, argmax_step} over records."""
    out: dict[str, dict] = {}
    for rec in records:
        step = rec.get("step")
        for key, val in rec.items():
            if key == "step" or not isinstance(val, (int, float)):
                continue
            s = out.setdefault(key, {
                "count": 0, "first": val, "last": val,
                "min": val, "max": val, "argmax_step": step,
            })
            s["count"] += 1
            s["last"] = val
            s["min"] = min(s["min"], val)
            if val >= s["max"]:
                s["max"] = val
                s["argmax_step"] = step
    return out


def write_csv(records: list[dict], path: str) -> None:
    keys = sorted({k for r in records for k in r if k != "step"})
    with open(path, "w") as fh:
        fh.write(",".join(["step"] + keys) + "\n")
        for rec in records:
            row = [str(rec.get("step", ""))]
            row += [
                repr(rec[k]) if isinstance(rec.get(k), (int, float)) else ""
                for k in keys
            ]
            fh.write(",".join(row) + "\n")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("metrics_file", help="JSONL from train --metrics-file")
    ap.add_argument("--csv", help="also write a step-per-row CSV here")
    args = ap.parse_args(argv)

    config, records = load_records(args.metrics_file)
    if not records:
        print("no metric records found", file=sys.stderr)
        return 1
    if config:
        keys = ("model", "batch_size", "epochs", "pretrain_epochs",
                "seed", "upscale_factor")
        shown = {k: config[k] for k in keys if k in config}
        print(f"config: {json.dumps(shown)}")

    stats = summarize(records)
    width = max(len(k) for k in stats)
    print(f"{'key'.ljust(width)}  {'n':>6}  {'first':>12}  {'last':>12}  "
          f"{'min':>12}  {'max':>12}  best@step")
    for key in sorted(stats):
        s = stats[key]
        print(f"{key.ljust(width)}  {s['count']:>6}  {s['first']:>12.5g}  "
              f"{s['last']:>12.5g}  {s['min']:>12.5g}  {s['max']:>12.5g}  "
              f"{s['argmax_step']}")

    if args.csv:
        write_csv(records, args.csv)
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
