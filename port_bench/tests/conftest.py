"""Tests of the benchmark's own code (the harness, the reference, the
comparisons), run on the CPU at small sizes:

    python -m pytest port_bench/tests -q

Tests that need a CUDA card carry the ``card`` marker and skip, inside
their fixture, where there is none; on the card they run the cells
themselves.
"""

from __future__ import annotations

import time

import pytest
import torch

# Small cells, full widths: what each test of a driver runs on the CPU.
TINY = {
    "esrgan.serve.frame-1080p": {
        "config": {"num_rrdb": 1},
        "traffic": {"deck": [{"lr_hw": [20, 24], "count": 2},
                             {"lr_hw": [28, 36], "count": 1}]},
        "cell": {"service": {"tile": 16, "overlap": 4, "tile_batch": 4,
                             "reference_batch": 8}}},
    "esrgan.train.gan-b64": {
        "config": {"num_rrdb": 1, "vgg_convs": 2},
        "traffic": {"batch": 4, "crop": 32, "batches_per_epoch": 6}},
    "srgan.train.pretrain-b128": {
        "config": {"num_residual": 2, "vgg_convs": 2},
        "traffic": {"batch": 4, "crop": 32, "batches_per_epoch": 12,
                    "steps_per_call": 3}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


@pytest.fixture
def card():
    """A CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cell on the card")
    return torch.device("cuda", 0)


def tiny_run(name: str, seed: int = 7, seconds: float = 0.5,
             hooks: dict | None = None) -> dict:
    """One run of ``name`` on the CPU at its ``TINY`` size, past the
    harness's look for a card; returns the result line."""
    from port_bench import harness, run

    r = harness.Run.of(name, seed=seed, seconds=seconds, trace=False,
                       device=torch.device("cpu"),
                       t_start=time.perf_counter(),
                       hooks={"overrides": TINY[name], **(hooks or {})})
    return run.execute(r)
