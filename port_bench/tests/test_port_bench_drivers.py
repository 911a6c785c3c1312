"""Each driver run end to end on the CPU at a small size, past the
harness's look for a card: a sound run comes out correct, and a run
with its timed path broken underneath comes out not correct, once for
each fault the cell can have."""

from __future__ import annotations

import pytest
import torch

from port_bench.tests.conftest import tiny_run


def test_serve_sound():
    line = tiny_run("esrgan.serve.frame-1080p")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"serve_output_mp_per_s",
                                    "serve_request_p95_ms",
                                    "device_peak_gib", "setup_s"}
    assert list(line)[-1] == "checks"


def test_serve_altered_answer():
    def after_build(service):
        forward = service._forward

        def altered(x):
            y = forward(x).clone()
            y[0] = y[0] + 0.5       # one tile of each batch, as produced
            return y

        service._forward = altered

    line = tiny_run("esrgan.serve.frame-1080p",
                    hooks={"after_build": after_build})
    assert not line["correct"]
    assert line["checks"]["max_abs_u8"]["value"] > line["checks"][
        "max_abs_u8"]["limit"]


TRAIN = ("esrgan.train.gan-b64", "srgan.train.pretrain-b128")


@pytest.mark.parametrize("name", TRAIN)
def test_train_sound(name):
    line = tiny_run(name)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"train_crops_per_s", "device_peak_gib",
                                    "setup_s"}


def _state_unchanged(trainer):
    for opt in trainer.opt.all():
        opt.step = lambda *a, **k: None


def _half_batch(trainer):
    from torchsr_tpu_torch.train import trainer as module

    pair = module.synthesize_pair

    def first_half(crops, flips, factor):
        return pair(crops[:len(crops) // 2], flips[:len(flips) // 2], factor)

    module.synthesize_pair = first_half  # the test's monkeypatch restores it


def _half_batch_late(trainer):
    """Half of the batch left out from the second step on: on the card
    the steps that replay the captured step, after the eager first."""
    from torchsr_tpu_torch.train import trainer as module

    pair, calls = module.synthesize_pair, []

    def late_half(crops, flips, factor):
        calls.append(len(crops))
        if len(calls) > 1:
            crops, flips = crops[:len(crops) // 2], flips[:len(flips) // 2]
        return pair(crops, flips, factor)

    module.synthesize_pair = late_half


# A half batch confined to the replayed steps is held in the SRGAN cell
# only: the GAN cell's numbers after its first step swing with rounding
# more than that fault moves them.
FAULTS = [pytest.param(name, fault, id=f"{fault.__name__[1:]}-{name}")
          for name in TRAIN for fault in (_state_unchanged, _half_batch)] + [
    pytest.param("srgan.train.pretrain-b128", _half_batch_late,
                 id="half_batch_late-srgan.train.pretrain-b128")]


@pytest.mark.parametrize("name, fault", FAULTS)
def test_train_fault(name, fault, monkeypatch):
    from torchsr_tpu_torch.train import trainer as module

    monkeypatch.setattr(module, "synthesize_pair", module.synthesize_pair)
    line = tiny_run(name, hooks={"after_build": fault})
    assert not line["correct"], line["checks"]


def test_forbidden_module_stops_the_result(monkeypatch, capsys):
    import sys

    from port_bench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run.harness, "card_line", lambda device: "cpu")
    monkeypatch.setattr(run, "execute", lambda r: {"correct": True,
                                                    "checks": {}})
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert run.main(["--workload", "esrgan.serve.frame-1080p", "--seed",
                     "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from port_bench import run

    assert run.main(["--workload", "esrgan.serve.frame-1080p", "--seed",
                     "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
