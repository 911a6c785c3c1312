"""The smooth quality corpus, rebuilt, against the JAX campaign's reports.

``tools/make_quality_dataset.py --photo-only --no-decimate`` rebuilds
the 24 evaluation images of the JAX package's round-5 smooth runs
(``artifacts/quality_r05/``), and the JAX package's own ``run_eval``
scores their bicubic baseline on the CPU (a one-block ESRGAN generator
does the model's half, which is not read here).  The rebuilt baseline
reads higher on every image than the campaign's reports, 33.97 dB
against 33.65 on the mean.  The images are not what differs: the same
resampling with each matrix product's operands rounded to bf16 (the
TPU's default precision for an f32 matrix product, one bf16 pass with
f32 sums) gives every campaign number, PSNR to 2e-4 dB and SSIM to
2e-5.  The campaign synthesized its LR images and its bicubic baseline
at that precision; ``run_eval`` on the CPU and the port's ``eval`` on
the card (TF32 off) compute them in f32.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_quality_corpus.py

prints the per-image table (f32, bf16 operands, the campaign's) as JSON.
"""

import json
import os
import subprocess
import sys
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np

from torchsr_tpu.infer.evaluate import _score_pair, run_eval
from torchsr_tpu.models import ESRGANGenerator
from torchsr_tpu.ops.resize import resample_matrix
from torchsr_tpu.utils import image_io
from torchsr_tpu.utils.checkpoint import save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGN = os.path.join(ROOT, "artifacts", "quality_r05",
                        "eval_esrgan_smooth_psnr-best.json")
# the campaign's report rounds PSNR to 4 decimals and SSIM to 5
TOL_PSNR_DB, TOL_SSIM = 2e-4, 2e-5


def _bf16(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _quantize(x: np.ndarray) -> np.ndarray:
    return (np.round(np.clip(x, 0.0, 1.0) * 255.0) * np.float32(1 / 255)
            ).astype(np.float32)


def resize_bf16_operands(x: np.ndarray, out_hw) -> np.ndarray:
    """``ops.resize.bicubic_resize(quantize=True)`` of one (H, W, 3)
    image (width pass, then height pass, each quantized) with each
    product's operands rounded to bf16 and f32 sums."""
    h_in, w_in = x.shape[:2]
    mw = _bf16(resample_matrix(w_in, out_hw[1]))
    x = _quantize(np.einsum("ow,hwc->hoc", mw, _bf16(x)))
    mh = _bf16(resample_matrix(h_in, out_hw[0]))
    return _quantize(np.einsum("oh,hwc->owc", mh, _bf16(x)))


def corpus_rows(workdir: str) -> tuple[dict, list]:
    """Rebuild the eval corpus in ``workdir``; returns ``run_eval``'s
    report on it and, per image, the bicubic PSNR and SSIM in f32 (the
    report's), with bf16 operands, and the campaign's."""
    out = os.path.join(workdir, "qds")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                 "make_quality_dataset.py"),
                    "--out", out, "--n-train", "1", "--photo-only",
                    "--no-decimate"], check=True, capture_output=True)
    gen = ESRGANGenerator(num_rrdb_blocks=1)
    variables = gen.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))
    ckpt = os.path.join(workdir, "esrgan-one-block.ckpt")
    save_checkpoint(ckpt, 1, "esrgan-psnr", jax.device_get(variables))
    report = run_eval(Namespace(image_dir=os.path.join(out, "eval"),
                                model="esrgan", checkpoint=ckpt),
                      ESRGANGenerator)
    with open(CAMPAIGN) as fh:
        campaign = {r["image"]: r for r in json.load(fh)["per_image"]}
    rows = []
    for r in report["per_image"]:
        hr = image_io.load_image(os.path.join(out, "eval", r["image"]))
        hr = hr.astype(np.float32) / 255.0
        h, w = hr.shape[:2]
        bic = resize_bf16_operands(resize_bf16_operands(hr, (h // 4,
                                                             w // 4)), (h, w))
        p, s, _ = _score_pair(bic, hr)
        c = campaign[r["image"]]
        rows.append({"image": r["image"], "hw": r["hw"],
                     "f32_psnr": r["bicubic_psnr"],
                     "bf16_operands_psnr": round(p, 4),
                     "campaign_psnr": c["bicubic_psnr"],
                     "f32_ssim": r["bicubic_ssim"],
                     "bf16_operands_ssim": round(s, 5),
                     "campaign_ssim": c["bicubic_ssim"]})
    return report, rows


def test_rebuilt_corpus_differs_from_the_campaign_only_in_precision(
        tmp_path):
    report, rows = corpus_rows(str(tmp_path))
    with open(CAMPAIGN) as fh:
        campaign = json.load(fh)
    assert [r["image"] for r in rows] == [
        r["image"] for r in campaign["per_image"]]
    assert all(r["hw"] == [176, 176] for r in rows) and len(rows) == 24
    # f32: every image above the campaign's number; the means of PERF.md
    assert all(r["f32_psnr"] > r["campaign_psnr"] for r in rows)
    assert abs(report["mean_bicubic_psnr"] - 33.97) <= 5e-3
    assert campaign["mean_bicubic_psnr"] == 33.65
    # bf16 operands: the campaign's numbers, image by image
    for r in rows:
        assert abs(r["bf16_operands_psnr"] - r["campaign_psnr"]) \
            <= TOL_PSNR_DB, r
        assert abs(r["bf16_operands_ssim"] - r["campaign_ssim"]) \
            <= TOL_SSIM, r


if __name__ == "__main__":
    import contextlib
    import tempfile

    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(sys.stderr):
        rep, table = corpus_rows(tmp)
    print(json.dumps({"mean_bicubic_psnr_f32": rep["mean_bicubic_psnr"],
                      "mean_bicubic_ssim_f32": rep["mean_bicubic_ssim"],
                      "rows": table}, indent=1))
