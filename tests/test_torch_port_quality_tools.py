"""The port's quality tools against the JAX package's, on the CPU.

- ``torchsr_tpu_torch/tools/make_quality_dataset.py``, the port's own
  corpus script, writes the same PNG files, byte for byte, as
  ``tools/make_quality_dataset.py`` run as a process
  (``--photo-only --no-decimate``, the round-5 smooth corpus).
- ``torchsr_tpu_torch/tools/metrics_summary.py`` prints the same table
  and writes the same CSV as ``tools/metrics_summary.py``, on a metrics
  file the port's trainer writes and on the JAX campaign's.
- ``quality_run --f32`` passes ``train --disable-amp`` and runs with
  TF32 off (and restores the caller's switches after); without it the
  caller's switches hold.
"""

import gzip
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torchsr_tpu_torch import cli
from torchsr_tpu_torch.tools import (
    make_quality_dataset,
    metrics_summary,
    quality_run,
)
from torchsr_tpu_torch.utils.image_io import save_image

ROOT = Path(__file__).resolve().parents[1]
CAMPAIGN_METRICS = (ROOT / "artifacts" / "quality_r05"
                    / "metrics_esrgan_smooth.jsonl.gz")


# for the module, its module fixtures included
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pre_port_tool(name: str):
    """``tools/<name>.py`` (numpy and the standard library) as a module."""
    spec = importlib.util.spec_from_file_location(
        f"pre_port_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_corpus_is_byte_equal_to_the_pre_port_script(tmp_path):
    flags = ["--photo-only", "--no-decimate"]
    subprocess.run([sys.executable, str(ROOT / "tools" /
                                        "make_quality_dataset.py"),
                    "--out", str(tmp_path / "pre_port"), *flags],
                   check=True, capture_output=True, timeout=600)
    assert make_quality_dataset.main(
        ["--out", str(tmp_path / "port"), *flags]) == 0
    for split, n in (("train", 200), ("eval", 24)):
        names = sorted(os.listdir(tmp_path / "pre_port" / split))
        assert sorted(os.listdir(tmp_path / "port" / split)) == names
        assert len(names) == n
        for name in names:
            assert ((tmp_path / "port" / split / name).read_bytes()
                    == (tmp_path / "pre_port" / split / name).read_bytes()
                    ), f"{split}/{name}"


@pytest.fixture(scope="module")
def port_metrics(tmp_path_factory):
    """The metrics file of a one-epoch-a-phase ``train`` of the port on
    four seeded 40 x 40 images (CPU, one RRDB, two VGG convs)."""
    root = tmp_path_factory.mktemp("port_metrics")
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(5)
    for i in range(4):
        save_image(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8),
                   str(images / f"img_{i}.png"))
    cwd = os.getcwd()
    os.chdir(root)
    old = os.environ.get("WANDB_MODE")
    os.environ["WANDB_MODE"] = "disabled"
    try:
        cli.main(["train", "--train-dir", str(images), "--device", "cpu",
                  "--gen-blocks", "1", "--vgg-convs", "2", "--crop-size",
                  "32", "--batch-size", "2", "--skip-image-save",
                  "--epochs", "1", "--pretrain-epochs", "1",
                  "--metrics-file", "metrics.jsonl"])
    finally:
        os.chdir(cwd)
        if old is None:
            os.environ.pop("WANDB_MODE", None)
        else:
            os.environ["WANDB_MODE"] = old
    return root / "metrics.jsonl"


@pytest.mark.parametrize("source", ["port_trainer", "campaign"])
def test_metrics_summary_matches_the_pre_port_tool(source, port_metrics,
                                                   tmp_path, capsys):
    if source == "campaign":
        path = tmp_path / "metrics_esrgan_smooth.jsonl"
        with gzip.open(CAMPAIGN_METRICS, "rb") as src, open(path, "wb") as dst:
            shutil.copyfileobj(src, dst)
    else:
        path = port_metrics
    pre_port = _pre_port_tool("metrics_summary")
    config, records = metrics_summary.load_records(str(path))
    assert (config, records) == pre_port.load_records(str(path))
    assert config and any("gan/PSNR" in r for r in records)
    assert metrics_summary.summarize(records) == pre_port.summarize(records)
    capsys.readouterr()
    assert pre_port.main([str(path), "--csv", str(tmp_path / "a.csv")]) == 0
    want = capsys.readouterr().out
    assert metrics_summary.main(
        [str(path), "--csv", str(tmp_path / "b.csv")]) == 0
    got = capsys.readouterr().out
    assert got.replace("b.csv", "a.csv") == want
    assert "gan/PSNR" in got
    assert (tmp_path / "b.csv").read_bytes() == (
        tmp_path / "a.csv").read_bytes()


def test_metrics_summary_refuses_an_empty_file(tmp_path, capsys):
    path = tmp_path / "empty.jsonl"
    path.write_text('{"config": {"model": "esrgan"}}\n')
    assert metrics_summary.main([str(path)]) == 1
    assert "no metric records found" in capsys.readouterr().err


class _Stop(Exception):
    pass


@pytest.mark.parametrize("f32", [False, True], ids=["default", "f32"])
def test_quality_run_f32_trains_in_f32_with_tf32_off(f32, tmp_path,
                                                     monkeypatch):
    """``quality_run``'s train call, stopped there: ``--disable-amp`` and
    TF32 off inside the run under ``--f32``; the caller's switches (here
    both on) inside it otherwise, and restored after it either way.
    The corpus comes from the port's own corpus script, with the CLI's
    defaults (200 training and 24 eval images, seed 4)."""
    seen = {}

    def train(argv):
        seen["argv"] = list(argv)
        seen["tf32"] = (torch.backends.cudnn.allow_tf32,
                        torch.backends.cuda.matmul.allow_tf32)
        raise _Stop

    def build(*a):
        seen["build"] = a[1:]

    monkeypatch.setattr(cli, "main", train)
    monkeypatch.setattr(make_quality_dataset, "build", build)
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(_Stop):
            quality_run.main(
                ["--model", "esrgan", "--device", "cpu",
                 "--out", str(tmp_path / "out"),
                 "--workdir", str(tmp_path / "work")]
                + (["--f32"] if f32 else []))
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
    assert seen["argv"][0] == "train"
    assert ("--disable-amp" in seen["argv"]) == f32
    assert seen["tf32"] == ((False, False) if f32 else (True, True))
    assert after == (True, True)
    # n_train, n_eval, seed, photo_only, decimate
    assert seen["build"] == (200, 24, 4, True, False)
