"""The control of each cell's check comes out not correct: the plain
reference put in the program's place in fp8 (the precision below the
configuration's bf16), judged by the cell's own comparison and limits,
on three seeds, at a size a test run holds (full depth and widths; a
small frame, a small batch).  ``port_bench/control.py`` reads the same
on the card at the cells' own sizes."""

from __future__ import annotations

import importlib

import pytest
import torch

from port_bench import generate, harness, weights
from port_bench.reference import ops, training

SIZES = {
    "esrgan.serve.frame-1080p": {
        "traffic": {"deck": [{"lr_hw": [40, 72], "count": 1}]},
        "cell": {"service": {"tile": 32, "overlap": 8, "tile_batch": 4,
                             "reference_batch": 4}}},
    "esrgan.train.gan-b64": {
        "traffic": {"batch": 4, "crop": 32, "batches_per_epoch": 3}},
    "srgan.train.pretrain-b128": {
        "traffic": {"batch": 4, "crop": 32, "batches_per_epoch": 3}},
}


def readings(name: str, seed: int) -> dict:
    from port_bench import compare
    from port_bench.drivers import serve, train

    run = harness.Run.of(name, seed=seed, seconds=0.0, trace=False,
                         device=torch.device("cpu"), t_start=0.0,
                         hooks={"overrides": SIZES[name]})
    if run.cell["driver"] == "serve":
        ref = importlib.import_module(
            f"port_bench.reference.{run.config['family']}")
        w = weights.make(ref.generator_specs(run.config), seed, "generator",
                         "cpu")
        mix = generate.Frames(run.traffic, seed)
        kept = {i: None for i in mix.sample(1, 1)}
        base = serve.reference_frames(run, w, mix, kept, "f32")
        low = serve.reference_frames(run, w, mix, kept, "fp8")
        return run, compare.frames(list(zip(low, base)))
    cfg, mix = run.config, run.traffic
    w = train.model_weights(cfg, mix, seed, "cpu")
    data = generate.Crops(mix, seed)
    batches = [tuple(torch.from_numpy(a) for a in data.batch(j))
               for j in range(3)]
    kw = {"phase": mix["phase"], "lr": mix["lr"]}
    with ops.exact_f32():
        base = training.run_steps(cfg, w, batches, **kw)
        low = training.run_steps(cfg, w, batches, prec="fp8", **kw)
    return run, compare.training(low, base)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_is_not_correct(name, seed):
    run, values = readings(name, seed)
    checks = harness.checks_from(values, run.cell["check"]["limits"])
    assert not harness.judge(checks), checks
