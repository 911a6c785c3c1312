"""Readings that set and test the data-parallel cells' correctness
limits, on one card at the cell's global batch; the benchmark's runs
never run this.

    python3 -m port_bench.control_ddp --workload esrgan.train.gan-b64-ddp4 \
        --seeds 1,2,3 [--readings fp8,no_exchange,...]

For each seed it makes the run's weights and global batches
(``drivers/train_ddp.py`` ``global_batch``), computes the plain f32
reference of the data-parallel step (``reference/ddp.py``, TF32 off) and
compares with it, by ``compare.training``, the readings asked for:
``fp8`` and ``bf16`` (the reference at those operand precisions, as
``control.py``); ``half_batch`` and ``half_batch_late`` (half of each
global batch left out, in every step or in the replayed steps 2-3);
``no_exchange`` (the gradient all-reduce left out: each rank steps on
its own gradient, ``ddp.run_ranks``); ``ranks`` (``run_ranks`` with the
exchange: the emulation itself, which has to read as sound).  One JSON
line a reading on standard output, each with the numbers that the
cell's limits hold and which of them it fails.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from port_bench import compare, harness
from port_bench.drivers.train import model_weights
from port_bench.drivers.train_ddp import global_batch
from port_bench.reference import ddp, ops

READINGS = ("fp8", "bf16", "half_batch", "half_batch_late", "no_exchange",
            "ranks")


def readings(run, seed: int, names: list) -> list:
    cfg, mix = run.config, run.traffic
    world = int(run.cell["chips"])
    w = model_weights(cfg, mix, seed, run.device, cfg.get("vgg_convs"))
    batches = [tuple(torch.from_numpy(a).to(run.device)
                     for a in global_batch(mix, seed, world, j))
               for j in range(3)]
    kw = {"lr": mix["lr"], "chunk": mix["batch"],
          "vgg_convs": cfg.get("vgg_convs")}
    limits = run.cell["check"]["limits"]
    out = []
    with ops.exact_f32():
        base = ddp.run_steps(cfg, w, batches, **kw)
        for name in names:
            t0 = time.perf_counter()
            if name in ("fp8", "bf16"):
                got = ddp.run_steps(cfg, w, batches, prec=name, **kw)
            elif name == "ranks":
                got = ddp.run_ranks(cfg, w, batches, lr=mix["lr"],
                                    world=world,
                                    vgg_convs=cfg.get("vgg_convs"))
            else:
                got = ddp.run_steps(cfg, w, batches, fault=name, **kw)
            values = compare.training(got, base)
            out.append({"reading": name, **values,
                        "fails": sorted(k for k, v in limits.items()
                                        if not values[k] <= v),
                        "worst": compare.worst_leaves(got, base),
                        "seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--readings", default=",".join(READINGS))
    args = p.parse_args(argv)
    names = args.readings.split(",")
    if set(names) - set(READINGS):
        p.error(f"readings: {sorted(set(names) - set(READINGS))}")
    harness.set_environment()
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run.of(args.workload, seed=seed, seconds=0.0,
                             trace=False, device=device, t_start=0.0)
        for row in readings(run, seed, names):
            print(json.dumps({"workload": run.name, "seed": seed, **row}),
                  flush=True)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
