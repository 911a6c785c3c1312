"""Repeat one of the JAX package's round-5 quality runs with the port.

The GAN-phase stability campaign (``docs/benchmarks.md``; configs and
reports under ``artifacts/quality_r05/``) trains on the smooth corpus
that ``make_quality_dataset --photo-only --no-decimate`` builds from
``media/waterfalls-low-res.png`` (200 training and 24 evaluation images
of 176 x 176), then scores the checkpoints with ``eval``.  This tool
runs the same recipe through the port's own entry points, in this
process:

1. the corpus, by the port's own copy of that script
   (``torchsr_tpu_torch/tools/make_quality_dataset.py``, numpy and
   Pillow only), in this process;
2. ``train`` with the run's config (line 1 of
   ``metrics_{model}_smooth.jsonl.gz``): ESRGAN batch 32, 60 pretrain
   and 20 GAN epochs; SRGAN batch 128, 40 and 40; both
   ``--dataset-multiplier 16 --seed 1 --skip-image-save`` (``--seed``
   sets another seed, for a spread over seeds; ``--f32`` adds
   ``--disable-amp`` and turns cuDNN's and CUDA matmul's TF32 off for
   the whole run, so that every product of both phases is f32);
3. ``eval`` on the eval images for psnr-best, gan-best and gan-latest,
   then ``interp`` of psnr-best and gan-best at alpha 0.2 and ``eval``
   of it; psnr-best is also scored with TF32 allowed and with
   ``--bf16``, to measure what each moves;
4. with ``--bf16-operands``, psnr-best once more on the JAX reports'
   yardstick: LR images and bicubic baseline synthesized with each
   resampling product's operands rounded to bf16 (``run_eval(...,
   lr_operands=torch.bfloat16)``), the precision the round-5 reports
   were made at, so that the port's SR and the campaign's see the same
   inputs; its per-image report is written beside the others and the
   summary sets its margin over bicubic beside JAX's.

It writes each report, the training metrics, and ``summary.json`` (the
reports' headline numbers beside the JAX reports', the per-epoch eval
PSNR beside the JAX curve at epochs 1, 5, 10, 20, 40 and 60 of each
phase, each phase's crops/s and step time as the run logged them, the
card's name and power limit) under ``--out``.

Usage: python -m torchsr_tpu_torch.tools.quality_run --model esrgan
       [--out build/quality/reports] [--device cuda|cpu] [--seed N]
       [--f32] [--bf16-operands] [--vgg-weights PATH]
       [--pretrain-epochs N --epochs N --batch-size N
        --dataset-multiplier N --gen-blocks N --vgg-convs N]
(the last flags shrink the recipe for a rehearsal on the CPU).
``--vgg-weights`` passes train's flag: the campaign's perceptual loss ran
on the JAX trainer's seeded random VGG19 features, which a JAX host can
write as a ``.ckpt`` for the port to train on the same features.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import io
import json
import os
import shutil
import statistics
import subprocess
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARTIFACTS = os.path.join(ROOT, "artifacts", "quality_r05")
RECIPES = {
    "esrgan": {"batch_size": 32, "pretrain_epochs": 60, "epochs": 20},
    "srgan": {"batch_size": 128, "pretrain_epochs": 40, "epochs": 40},
}
CURVE_EPOCHS = (1, 5, 10, 20, 40, 60)
REPORTS = ("psnr-best", "gan-best", "gan-latest", "interp_0.2")
HEADLINE = ("images", "mean_psnr", "mean_ssim", "batch_psnr",
            "mean_bicubic_psnr", "mean_bicubic_ssim", "psnr_margin_db",
            "ssim_margin", "images_beating_bicubic_psnr")


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


def jax_curves(model: str) -> dict:
    """The committed JAX run's per-epoch eval PSNR, by phase."""
    path = os.path.join(ARTIFACTS, f"metrics_{model}_smooth.jsonl.gz")
    return _curves(json.loads(line) for line in gzip.open(path, "rt"))


def _curves(rows) -> dict:
    out = {"psnr": {}, "gan": {}}
    for row in rows:
        for phase in out:
            if f"{phase}/PSNR" in row:
                out[phase][int(row[f"{phase}/epoch"])] = row[f"{phase}/PSNR"]
    return out


def _throughput(rows, batch: int) -> dict:
    """Each phase's logged crops/s (median over its epochs after the
    first, which includes the warm-up) and the step time it implies."""
    out = {}
    for phase in ("psnr", "gan"):
        rates = [r[f"{phase}/throughput/train"] for r in rows
                 if f"{phase}/throughput/train" in r]
        if rates:
            med = statistics.median(rates[1:] or rates)
            out[phase] = {"crops_per_s": med, "step_ms": batch / med * 1e3,
                          "first_epoch_crops_per_s": rates[0],
                          "epochs": len(rates)}
    return out


def _headline(report: dict) -> dict:
    return {k: report[k] for k in HEADLINE}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=sorted(RECIPES), required=True)
    parser.add_argument("--out", default=os.path.join("build", "quality",
                                                      "reports"))
    parser.add_argument("--workdir", default=os.path.join("build",
                                                          "quality"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--pretrain-epochs", type=int)
    parser.add_argument("--epochs", type=int)
    parser.add_argument("--batch-size", type=int)
    parser.add_argument("--dataset-multiplier", type=int, default=16)
    parser.add_argument("--gen-blocks", type=int)
    parser.add_argument("--vgg-convs", type=int)
    parser.add_argument("--seed", type=int, default=1,
                        help="train's --seed (the round-5 runs' is 1)")
    parser.add_argument("--vgg-weights",
                        help="train's --vgg-weights (default: the port's "
                             "seeded random features)")
    parser.add_argument("--f32", action="store_true",
                        help="train in f32 (train's --disable-amp) with "
                             "TF32 off for the whole run")
    parser.add_argument("--bf16-operands", action="store_true",
                        help="also score psnr-best with the LR and the "
                             "bicubic baseline synthesized at the JAX "
                             "reports' precision (bf16 operands)")
    args = parser.parse_args(argv)

    from torchsr_tpu_torch.infer.evaluate import tf32_allowed

    # --f32 turns TF32 off for the whole run; otherwise PyTorch's
    # defaults hold (cuDNN TF32 on, matmul TF32 off)
    with tf32_allowed(False) if args.f32 else contextlib.nullcontext():
        return _run(args)


def _run(args) -> dict:
    import torch

    from torchsr_tpu_torch import cli
    from torchsr_tpu_torch.infer.evaluate import run_eval
    from torchsr_tpu_torch.registry import select_test_model
    from torchsr_tpu_torch.tools import make_quality_dataset

    recipe = dict(RECIPES[args.model])
    for key in recipe:
        if getattr(args, key) is not None:
            recipe[key] = getattr(args, key)
    out = os.path.abspath(os.path.join(args.out, args.model))
    work = os.path.abspath(os.path.join(args.workdir, args.model))
    vgg_weights = args.vgg_weights and os.path.abspath(args.vgg_weights)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.makedirs(out, exist_ok=True)
    corpus = os.path.join(work, "qds")
    with contextlib.redirect_stdout(io.StringIO()):
        make_quality_dataset.main(["--out", corpus, "--photo-only",
                                   "--no-decimate"])
    os.environ.setdefault("WANDB_MODE", "disabled")  # no network sink
    t0 = time.time()
    cwd = os.getcwd()
    os.chdir(work)
    try:
        train_argv = [
            "train", "--model", args.model, "--device", args.device,
            "--train-dir", os.path.join(corpus, "train"),
            "--eval-dir", os.path.join(corpus, "eval"),
            "--batch-size", str(recipe["batch_size"]),
            "--dataset-multiplier", str(args.dataset_multiplier),
            "--pretrain-epochs", str(recipe["pretrain_epochs"]),
            "--epochs", str(recipe["epochs"]), "--seed", str(args.seed),
            "--skip-image-save", "--metrics-file", "metrics.jsonl"]
        if args.f32:
            train_argv.append("--disable-amp")
        for flag, value in (("--gen-blocks", args.gen_blocks),
                            ("--vgg-convs", args.vgg_convs),
                            ("--vgg-weights", vgg_weights)):
            if value:
                train_argv += [flag, str(value)]
        cli.main(train_argv)
        train_s = time.time() - t0
        m = args.model
        cli.main(["interp", f"{m}-psnr-best.pth", f"{m}-gan-best.pth",
                  "--alpha", "0.2", "--model", m,
                  "-o", f"{m}-interp_0.2.pth"])
        reports = {}
        for name in REPORTS:
            eval_args = cli.parse_args([
                "eval", os.path.join(corpus, "eval"), "--model", m,
                "--checkpoint", f"{m}-{name}.pth", "--device", args.device,
                "--report", os.path.join(out, f"eval_{m}_smooth_{name}.json")])
            with contextlib.redirect_stdout(io.StringIO()):
                reports[name] = run_eval(eval_args,
                                         select_test_model(eval_args))
        eval_args = cli.parse_args([
            "eval", os.path.join(corpus, "eval"), "--model", m,
            "--checkpoint", f"{m}-psnr-best.pth", "--device", args.device])
        with contextlib.redirect_stdout(io.StringIO()):
            tf32 = run_eval(eval_args, select_test_model(eval_args),
                            allow_tf32=True)
            eval_args.bf16 = True
            bf16 = run_eval(eval_args, select_test_model(eval_args))
            if args.bf16_operands:
                eval_args.bf16 = False
                eval_args.report = os.path.join(
                    out, f"eval_{m}_smooth_psnr-best_bf16_operands.json")
                reports["psnr-best_bf16_operands"] = run_eval(
                    eval_args, select_test_model(eval_args),
                    lr_operands=torch.bfloat16)
        shutil.copy("metrics.jsonl", os.path.join(out, "metrics.jsonl"))
        with open("metrics.jsonl") as fh:
            rows = [json.loads(line) for line in fh]
    finally:
        os.chdir(cwd)

    ours = _curves(rows)
    theirs = jax_curves(args.model)
    jax_reports = {}
    for name in REPORTS:
        path = os.path.join(ARTIFACTS, f"eval_{args.model}_smooth_{name}.json")
        if os.path.exists(path):
            with open(path) as fh:
                jax_reports[name] = _headline(json.load(fh))
    base = reports["psnr-best"]["per_image"]
    summary = {
        "model": args.model, "card": card(), "recipe": recipe,
        "seed": args.seed, "vgg_weights": args.vgg_weights,
        "f32": args.f32,
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                 "matmul": torch.backends.cuda.matmul.allow_tf32},
        "rdb_bwd": os.environ.get("TORCHSR_RDB_BWD", "pallas"),
        "dataset_multiplier": args.dataset_multiplier,
        "train_wall_s": train_s, "wall_s": time.time() - t0,
        "reports": {k: _headline(v) for k, v in reports.items()},
        "jax_reports": jax_reports,
        "curves": {phase: {e: [ours[phase].get(e), theirs[phase].get(e)]
                           for e in CURVE_EPOCHS
                           if e in ours[phase] or e in theirs[phase]}
                   for phase in ("psnr", "gan")},
        "best_epoch": {phase: max(ours[phase], key=ours[phase].get)
                       for phase in ours if ours[phase]},
        "throughput": _throughput(rows, recipe["batch_size"]),
        "psnr_best_tf32_on": _headline(tf32),
        "psnr_best_tf32_on_minus_off": {
            "mean_psnr": tf32["mean_psnr"] - reports["psnr-best"]["mean_psnr"],
            "mean_ssim": tf32["mean_ssim"] - reports["psnr-best"]["mean_ssim"],
            "max_abs_per_image_psnr": max(
                abs(a["psnr"] - b["psnr"])
                for a, b in zip(tf32["per_image"], base)),
            "max_abs_per_image_ssim": max(
                abs(a["ssim"] - b["ssim"])
                for a, b in zip(tf32["per_image"], base))},
        "psnr_best_bf16": _headline(bf16),
    }
    if args.bf16_operands and "psnr-best" in jax_reports:
        ours_margin = reports["psnr-best_bf16_operands"]["psnr_margin_db"]
        theirs_margin = jax_reports["psnr-best"]["psnr_margin_db"]
        summary["psnr_best_margin_vs_jax"] = {
            "f32_lr": reports["psnr-best"]["psnr_margin_db"],
            "bf16_operands_lr": ours_margin, "jax": theirs_margin,
            "bf16_operands_gap_db": ours_margin - theirs_margin}
    with open(os.path.join(out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    finite = all(np.isfinite(v) for r in reports.values()
                 for k, v in r.items() if k in HEADLINE)
    if not finite:
        raise SystemExit("a report holds a non-finite value")
    return summary


if __name__ == "__main__":
    main()
