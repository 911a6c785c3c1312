"""``python -m torchsr_tpu_torch doctor`` on the CPU: the knobs and the
RDB variant they select, the kernel libraries, and the dataset and
checkpoint probes."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
from torchsr_tpu_torch.ops import _build
from torchsr_tpu_torch.utils import doctor
from torchsr_tpu_torch.utils.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parents[1]


def test_doctor_json_reports_the_knobs():
    """In a fresh process with the knobs set: their values, the variant
    they select, every kernel library, and no device."""
    env = {"TORCHSR_RDB_EXT": "1", "TORCHSR_RDB_BWD": "xla",
           "PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "torchsr_tpu_torch", "doctor", "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    knobs = report["env_knobs"]
    assert knobs["TORCHSR_RDB_EXT"]["value"] == "1"
    assert knobs["TORCHSR_RDB_BWD"]["value"] == "xla"
    rdb = report["rdb_kernels"]
    assert rdb["EXT_KERNEL"] is True and rdb["BWD_XLA"] is True
    assert rdb["ILV_KERNEL"] is False
    assert "B7" in rdb["training"] and "plain" in rdb["training"]
    assert report["cuda"]["available"] is False
    assert set(report["kernels"]) == set(_build.SIGNATURES)


def test_doctor_probes_a_dataset_and_a_checkpoint(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    for i in range(10):
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).save(
            tmp_path / f"img{i}.png")
    gen = ESRGANGenerator(num_rrdb_blocks=2,
                          generator=torch.Generator().manual_seed(0))
    ckpt = tmp_path / "esrgan-gan-best.pth"
    save_checkpoint(str(ckpt), 3, "esrgan-gan", gen.state_dict())
    monkeypatch.chdir(tmp_path)
    report = doctor.collect_report(train_dir=str(tmp_path),
                                   checkpoint=str(ckpt))
    assert report["dataset"]["train_images"] == 9
    assert report["dataset"]["val_images"] == 1
    info = report["checkpoint"]
    assert (info["epoch"], info["phase"]) == (3, "esrgan-gan")
    assert (info["detected_blocks"], info["detected_scale"]) == (2, 4)
    assert info["generator_params"] == sum(
        p.numel() for p in gen.state_dict().values())
    assert report["cwd_checkpoints"][0].startswith("esrgan-gan-best.pth")
    missing = doctor.collect_report(train_dir=str(tmp_path / "nope"),
                                    checkpoint=str(tmp_path / "nope.pth"))
    assert "error" in missing["dataset"]
    assert missing["checkpoint"]["error"] == "file not found"
