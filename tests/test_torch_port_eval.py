"""The port's ``eval`` against the JAX package's ``run_eval``, on the CPU.

The same checkpoint (a JAX ``.ckpt`` both packages read) scores the
same directory of seeded images in both: mixed sizes, one whose sides
are not multiples of 4, one below the 11 x 11 SSIM window; whole-image,
``--tile``d and ``--crop``ped, for a 1-RRDB ESRGAN and a 1-block SRGAN
(BatchNorm statistics away from their init).  Also: the metric-grade
TF32 switches, the refusals (``--artifact``, a ``.tsrpack``, a missing
card) and the CLI's report.
"""

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torchsr_tpu.infer.evaluate import run_eval as jax_run_eval
from torchsr_tpu.models import ESRGANGenerator as JaxESRGAN
from torchsr_tpu.models import SRGANGenerator as JaxSRGAN
from torchsr_tpu.utils.checkpoint import save_checkpoint as jax_save
from torchsr_tpu_torch import cli
from torchsr_tpu_torch.infer import evaluate
from torchsr_tpu_torch.models.esrgan import ESRGANGenerator
from torchsr_tpu_torch.models.srgan import SRGANGenerator

# per-image PSNR (dB) and SSIM of the SR image: the same f32
# computations in two frameworks (the generator's sums, the SSIM blur)
# on the same LR (equal here at every value); measured equal after the
# report's rounding
TOL_PSNR, TOL_SSIM = 2e-3, 2e-5
# the SR images themselves (the seeded generators score only ~4 dB, so
# the scores alone would not see a small error): f32 sums in another
# order
ATOL_SR = 1e-5
# the bicubic baseline's: its quantized re-upscale rounds ties one uint8
# level apart where the f32 sums differ in order (ROADMAP C, a known
# difference: 5 of 4,800 values here); measured 4e-4 dB and 3e-5
TOL_BIC_PSNR, TOL_BIC_SSIM = 2e-3, 1e-4
SIZES = {"a.png": (40, 48), "b.png": (38, 45), "c.png": (9, 30),
         "d.png": (52, 44)}


# one torch thread for the module, its module fixtures included: the
# test workers share the machine's cores
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _structured(rng, h, w):
    """Smooth waves and noise: bicubic recovers real signal."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = (127 + 80 * np.sin(yy / 9.0) + 40 * np.cos(xx / 7.0))[..., None]
    noise = rng.normal(0, 6, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_port_eval")
    rng = np.random.default_rng(11)
    (root / "val").mkdir()
    for name, hw in SIZES.items():
        Image.fromarray(_structured(rng, *hw)).save(root / "val" / name)
    ckpts = {}
    x = jnp.zeros((1, 8, 8, 3))
    for model, gen in (("esrgan", JaxESRGAN(num_rrdb_blocks=1)),
                       ("srgan", JaxSRGAN(num_residual=1))):
        variables = jax.tree.map(np.asarray, dict(
            gen.init(jax.random.PRNGKey(2), x, train=False)))
        if "batch_stats" in variables:
            srng = np.random.default_rng(5)
            variables["batch_stats"] = jax.tree.map(
                lambda a: (srng.uniform(0.5, 1.5, a.shape)
                           * (a if a.any() else 0.05)).astype(a.dtype),
                variables["batch_stats"])
        ckpts[model] = str(root / f"{model}-gan-best.ckpt")
        jax_save(ckpts[model], 1, "gan", variables)
    return str(root / "val"), ckpts


def _args(image_dir, model, ckpt, **kw):
    base = dict(image_dir=image_dir, model=model, checkpoint=ckpt,
                crop=None, tile=0, tile_overlap=16, tile_batch=8, bf16=False,
                save_sr=False, report=None, seed=0)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize(
    "model, kw",
    [("esrgan", {}), ("esrgan", {"tile": 16, "tile_overlap": 4,
                                 "tile_batch": 3}),
     ("esrgan", {"crop": 40}), ("srgan", {}),
     ("srgan", {"tile": 16, "tile_overlap": 4, "tile_batch": 3})],
    ids=["esrgan", "esrgan-tiled", "esrgan-crop", "srgan", "srgan-tiled"],
)
def test_report_matches_jax(setup, model, kw, capsys, monkeypatch):
    import torchsr_tpu.infer.evaluate as jax_evaluate

    image_dir, ckpts = setup
    saved = {"jax": {}, "port": {}}
    for side, module in (("jax", jax_evaluate), ("port", evaluate)):
        monkeypatch.setattr(
            module.image_io, "save_image",
            lambda img, path, d=saved[side]: d.__setitem__(
                path, np.array(img)))
    want = jax_run_eval(_args(image_dir, model, ckpts[model], artifact=None,
                              save_sr=True, **kw),
                        {"esrgan": JaxESRGAN, "srgan": JaxSRGAN}[model])
    jax_out = capsys.readouterr().out
    generator_cls = {"esrgan": ESRGANGenerator, "srgan": SRGANGenerator}
    got = evaluate.run_eval(_args(image_dir, model, ckpts[model],
                                  device="cpu", save_sr=True, **kw),
                            generator_cls[model])
    port_out = capsys.readouterr().out
    assert list(saved["port"]) == list(saved["jax"])
    for path, sr in saved["port"].items():
        np.testing.assert_allclose(sr, saved["jax"][path], atol=ATOL_SR,
                                   rtol=0, err_msg=path)
    assert set(got) == set(want)
    assert got["model"] == model and got["images"] == want["images"]
    # the skip rules: c.png is below the SSIM window; with --crop 40,
    # b.png (38 rows) is below the crop too
    skipped = {"c.png"} | ({"b.png"} if kw.get("crop") else set())
    assert [r["image"] for r in got["per_image"]] == sorted(
        set(SIZES) - skipped)
    for name in skipped:
        assert f"skipping {os.path.join(image_dir, name)}" in port_out
        assert f"skipping {os.path.join(image_dir, name)}" in jax_out
    for ours, theirs in zip(got["per_image"], want["per_image"]):
        assert ours["image"] == theirs["image"]
        assert ours["hw"] == theirs["hw"]
        assert ours["hw"][0] % 4 == 0 and ours["hw"][1] % 4 == 0
        for key, tol in (("psnr", TOL_PSNR), ("bicubic_psnr", TOL_BIC_PSNR),
                         ("ssim", TOL_SSIM),
                         ("bicubic_ssim", TOL_BIC_SSIM)):
            assert abs(ours[key] - theirs[key]) <= tol, (key, ours, theirs)
    for key, tol in (("mean_psnr", TOL_PSNR), ("batch_psnr", TOL_PSNR),
                     ("mean_bicubic_psnr", TOL_BIC_PSNR),
                     ("psnr_margin_db", TOL_PSNR + TOL_BIC_PSNR),
                     ("mean_ssim", TOL_SSIM),
                     ("mean_bicubic_ssim", TOL_BIC_SSIM),
                     ("ssim_margin", TOL_SSIM + TOL_BIC_SSIM)):
        assert abs(got[key] - want[key]) <= tol, key
    assert (got["images_beating_bicubic_psnr"]
            == want["images_beating_bicubic_psnr"])


def test_eval_is_metric_grade_f32_and_restores_tf32(setup, monkeypatch):
    """TF32 is off while the generator runs (and on where asked for);
    the caller's switches come back either way."""
    image_dir, ckpts = setup
    seen = []
    load = evaluate.load_trained_generator

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32,
                     kw["compute_dtype"]))
        return load(*a, **kw)

    monkeypatch.setattr(evaluate, "load_trained_generator", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    args = _args(image_dir, "esrgan", ckpts["esrgan"], device="cpu",
                 crop=40)
    evaluate.run_eval(args, ESRGANGenerator)
    evaluate.run_eval(args, ESRGANGenerator, allow_tf32=True)
    args.bf16 = True
    evaluate.run_eval(args, ESRGANGenerator)
    assert seen == [(False, False, torch.float32),
                    (True, True, torch.float32),
                    (False, False, torch.bfloat16)]
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_eval_refusals(setup, tmp_path, monkeypatch):
    image_dir, ckpts = setup
    with pytest.raises(SystemExit):  # an artifact's dtype is baked in
        cli.parse_args(["eval", image_dir, "--artifact", "art.pt2",
                        "--bf16"])
    # a pack cut short (the magic and 16 bytes): the reader's error
    pack = tmp_path / "val.tsrpack"
    pack.write_bytes(b"TSRPACK1" + bytes(16))
    with pytest.raises(ValueError, match="truncated"):
        evaluate.run_eval(_args(str(pack), "esrgan", ckpts["esrgan"],
                                device="cpu"), ESRGANGenerator)
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no supported images"):
        evaluate.run_eval(_args(str(tmp_path / "empty"), "esrgan",
                                ckpts["esrgan"], device="cpu"),
                          ESRGANGenerator)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in ("esrgan", "srgan"):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["eval", image_dir, "--model", model,
                      "--checkpoint", ckpts[model]])


def test_eval_on_a_pack_equals_the_directory(setup, tmp_path):
    """``eval`` on the ``.tsrpack`` of the directory (written by the JAX
    package's ``pack_dataset``) reports what it reports on the
    directory."""
    from torchsr_tpu.data.packed import pack_dataset

    image_dir, ckpts = setup
    pack = str(tmp_path / "val.tsrpack")
    pack_dataset(image_dir, pack)
    reports = [evaluate.run_eval(_args(path, "esrgan", ckpts["esrgan"],
                                       device="cpu", crop=40),
                                 ESRGANGenerator)
               for path in (image_dir, pack)]
    assert reports[0] == reports[1]


def test_cli_eval_writes_the_report(setup, tmp_path, monkeypatch):
    image_dir, ckpts = setup
    monkeypatch.chdir(tmp_path)
    cli.main(["eval", image_dir, "--model", "srgan", "--checkpoint",
              ckpts["srgan"], "--device", "cpu", "--report", "r.json",
              "--save-sr"])
    with open("r.json") as fh:
        report = json.load(fh)
    assert list(report) == [
        "model", "images", "mean_psnr", "mean_ssim", "batch_psnr",
        "mean_bicubic_psnr", "mean_bicubic_ssim", "per_image",
        "psnr_margin_db", "ssim_margin", "images_beating_bicubic_psnr"]
    assert report["images"] == 3 and report["model"] == "srgan"
    for row in report["per_image"]:
        assert all(np.isfinite(row[k]) for k in ("psnr", "ssim"))
        with Image.open(f"upres-{row['image']}") as img:
            assert img.size == (row["hw"][1], row["hw"][0])
