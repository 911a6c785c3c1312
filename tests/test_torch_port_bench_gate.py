"""The port's bench regression gate (``torchsr_tpu_torch/tools/
bench_regression.py``) and its floors (``bench_expectations.json``
beside it), on the CPU: the gate passes on bench lines at or above
every floor, and fails on a metric that is missing or below its floor;
a withheld floor still requires its metric.  The floors file names the
bench's five metrics, and each entry the card (an H100, never a TPU),
its power limit, the commit and the date it was measured on."""

import json
import os

import pytest

from torchsr_tpu_torch.tools import bench_regression as gate

METRICS = (
    "esrgan_gan_step_crops_per_sec_per_chip",
    "srgan_gan_step_crops_per_sec_per_chip",
    "esrgan_tiled_infer_output_mp_per_sec",
    "srgan_tiled_infer_output_mp_per_sec",
    "srgan_train_crops_per_sec_per_chip",
)


def _lines(values: dict) -> str:
    rows = [json.dumps({"metric": k, "value": v, "unit": "x",
                        "device": "NVIDIA H100 80GB HBM3",
                        "power_limit_w": 700.0}) for k, v in values.items()]
    return "bench: some stderr chatter\n" + "\n".join(rows) + "\n"


def _at_floor(floors: dict, scale: float = 1.0) -> dict:
    return {k: (spec["min"] or spec["reference"]) * scale
            for k, spec in floors.items()}


def test_floors_file_names_the_five_metrics_and_the_card():
    floors = gate.load_floors()
    assert set(floors) == set(METRICS)
    for name, spec in floors.items():
        assert spec["device"].startswith("NVIDIA H100"), name
        assert spec["power_limit_w"] == 700.0
        assert spec["commit"] and spec["date"]
        assert not any(w in spec["device"].lower()
                       for w in ("tpu", "v5e", "v4", "v6e")), name
        assert len(spec["runs"]) == 2
        assert spec["reference"] == spec["runs"][-1]
        if spec["min"] is None:
            assert spec["withheld"]
        else:
            assert spec["min"] <= 0.9 * spec["reference"]


@pytest.mark.parametrize("scale, ok", [(1.0, True), (1.3, True),
                                       (0.999, False)])
def test_gate_against_the_floors(scale, ok):
    floors = gate.load_floors()
    passed, lines = gate.check(gate.parse_metrics(
        _lines(_at_floor(floors, scale))), floors)
    withheld = [k for k, s in floors.items() if s["min"] is None]
    # a withheld floor passes whatever the value
    assert passed is (ok or len(withheld) == len(floors))
    if not ok:
        assert any(line.startswith("REGRESSION") for line in lines)


def test_gate_fails_on_a_missing_metric():
    floors = gate.load_floors()
    for name in floors:
        values = _at_floor(floors)
        del values[name]
        passed, lines = gate.check(gate.parse_metrics(_lines(values)),
                                   floors)
        assert not passed
        assert f"MISSING {name} (floor {floors[name]['min']})" in lines


def test_gate_main_on_a_saved_output(tmp_path):
    floors = gate.load_floors()
    good = tmp_path / "good.txt"
    good.write_text(_lines(_at_floor(floors, 1.1)))
    assert gate.main(["--check", str(good)]) == 0
    values = _at_floor(floors, 1.1)
    values.pop(METRICS[0])
    bad = tmp_path / "bad.txt"
    bad.write_text(_lines(values))
    assert gate.main(["--check", str(bad)]) == 1
    custom = tmp_path / "floors.json"
    custom.write_text(json.dumps({METRICS[0]: {
        "min": 10.0, "reference": 12.0, "device": "NVIDIA H100 80GB HBM3",
        "power_limit_w": 700.0}}))
    low = tmp_path / "low.txt"
    low.write_text(_lines({METRICS[0]: 9.5}))
    assert gate.main(["--check", str(low), "--expectations",
                      str(custom)]) == 1
    assert os.path.exists(gate.EXPECTATIONS)
