"""Readings that set the upper ends of the cells' correctness limits,
on the card at the cells' own sizes; the benchmark's runs never run
this.

    python3 -m port_bench.control --workload <cell> --seeds 1,2,3

For each seed it makes the run's weights and inputs, computes the plain
f32 reference (TF32 off) of what the cell checks, and compares with it,
by the cell's own comparison, (1) the control: the reference put in the
program's place in the nearest precision below the configuration's
bf16, fp8 (``reference/ops.py``: e4m3 operands, e5m2 gradients,
per-tensor scales); (2) the reference in bf16 operands, for the record;
(3) for training cells the fault "half of the batch left out, the mean
taken over the rest" planted in the reference, in every step and (4) in
steps 2 and 3 alone, those that the program runs as replays of its
captured step.  ("A step that returns
its state unchanged" reads 1 on ``change_gap`` by definition.)  One
JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from port_bench import compare, generate, harness, weights
from port_bench.reference import ops, training


def serve_readings(run, seed: int) -> list:
    from port_bench.drivers.serve import reference_frames

    ref = __import__(f"port_bench.reference.{run.config['family']}",
                     fromlist=["generator_specs"])
    w = weights.make(ref.generator_specs(run.config), seed, "generator",
                     run.device)
    mix = generate.Frames(run.traffic, seed)
    check = run.cell["check"]
    kept = {i: None for i in mix.sample(check["per_size"], check["decks"])}
    base = reference_frames(run, w, mix, kept, "f32")
    out = []
    for prec in ("fp8", "bf16"):
        t0 = time.perf_counter()
        frames = reference_frames(run, w, mix, kept, prec)
        out.append({"reading": f"reference_{prec}", **compare.frames(
            list(zip(frames, base))),
            "seconds": time.perf_counter() - t0})
    return out


def train_readings(run, seed: int) -> list:
    from port_bench.drivers.train import model_weights

    cfg, mix = run.config, run.traffic
    w = model_weights(cfg, mix, seed, run.device, cfg.get("vgg_convs"))
    data = generate.Crops(mix, seed)
    batches = [tuple(torch.from_numpy(a).to(run.device)
                     for a in data.batch(j)) for j in range(3)]
    kw = {"phase": mix["phase"], "lr": mix["lr"],
          "vgg_convs": cfg.get("vgg_convs")}
    with ops.exact_f32():
        base = training.run_steps(cfg, w, batches, **kw)
        out = []
        for name, extra in (("reference_fp8", {"prec": "fp8"}),
                            ("reference_bf16", {"prec": "bf16"}),
                            ("fault_half_batch", {"fault": "half_batch"}),
                            ("fault_half_batch_late",
                             {"fault": "half_batch_late"})):
            t0 = time.perf_counter()
            got = training.run_steps(cfg, w, batches, **kw, **extra)
            out.append({"reading": name, **compare.training(got, base),
                        "worst": compare.worst_leaves(got, base),
                        "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    harness.set_environment()
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run.of(args.workload, seed=seed, seconds=0.0,
                             trace=False, device=device, t_start=0.0)
        read = (serve_readings if run.cell["driver"] == "serve"
                else train_readings)
        for row in read(run, seed):
            print(json.dumps({"workload": run.name, "seed": seed, **row}),
                  flush=True)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
