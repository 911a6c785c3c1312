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


def test_doctor_reads_an_srgan_checkpoint(tmp_path):
    """An SRGAN checkpoint: its model, residual-block count and scale
    (from ``conv_layers.{i}``), with a 2x one to tell the scale from the
    default."""
    from torchsr_tpu_torch.models.srgan import SRGANGenerator

    gen = SRGANGenerator(scale_factor=2, num_residual=3, device="meta")
    sd = {k: torch.zeros(v.shape, dtype=v.dtype)
          for k, v in gen.state_dict().items()}
    ckpt = tmp_path / "srgan-gan-best.pth"
    save_checkpoint(str(ckpt), 2, "srgan-gan", sd)
    info = doctor.collect_report(checkpoint=str(ckpt))["checkpoint"]
    assert (info["detected_model"], info["detected_blocks"],
            info["detected_scale"]) == ("srgan", 3, 2)


def test_doctor_device_check_and_no_device_check(tmp_path, monkeypatch):
    """The card probe (the JAX doctor's ``device_sanity``) runs by
    default and reports the missing card here; ``--no-device-check``
    leaves it out (the JAX flag); the build cache and a packed dataset
    are reported."""
    from torchsr_tpu_torch.data.packed import pack_dataset

    for i in range(10):
        Image.fromarray(np.full((8, 8, 3), i, np.uint8)).save(
            tmp_path / f"img{i}.png")
    pack_dataset(str(tmp_path), str(tmp_path / "ds.tsrpack"))
    monkeypatch.setenv("TORCHSR_COMPILE_CACHE", str(tmp_path / "kc"))
    report = doctor.collect_report(train_dir=str(tmp_path / "ds.tsrpack"))
    assert report["device_sanity"]["ok"] is False
    assert "no CUDA device" in report["device_sanity"]["error"]
    assert report["kernel_build_cache"] == {
        "dir": str(tmp_path / "kc"),
        "from": f"TORCHSR_COMPILE_CACHE={tmp_path / 'kc'}"}
    assert (report["dataset"]["train_images"],
            report["dataset"]["val_images"]) == (9, 1)
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "torchsr_tpu_torch", "doctor", "--json",
         "--no-device-check"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "device_sanity" not in json.loads(proc.stdout)
    proc = subprocess.run(
        [sys.executable, "-m", "torchsr_tpu_torch", "doctor"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "device_sanity:" in proc.stdout
    assert proc.stdout.rstrip().endswith("verdict: PROBLEMS")
