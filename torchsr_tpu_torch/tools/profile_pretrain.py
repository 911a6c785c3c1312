"""Section profile of the SRGAN pretrain step on one CUDA card.

    python -m torchsr_tpu_torch.tools.profile_pretrain [--batch 128]
        [--crop 96] [--reps 8] [--components conv1,tower,...]

The port of the JAX package's ``tools/profile_pretrain.py``: the
headline metric's step (``bench.py``'s ``srgan_train_crops_per_sec_per_
chip``: the SRGAN pretrain at batch 128, crop 96, bf16) taken apart into
the generator's sections and the step's other pieces, each timed as
``tools/profile_gan_step.py`` times its components (``chained_ms``,
``device_ms``, ``kernels``, ``busy_share``).  Sections run forward and
backward (gradients with respect to their parameters and input), in
train mode, on seeded bf16 inputs of the shapes the step gives them:

  conv1      9x9 3->64 + PReLU at LR
  tower      the 16 residual blocks (conv-BN-PReLU-conv-BN + skip) at LR
  bn1        ONE train-mode BatchNorm at the tower shape (x33 ~ the
             generator's BatchNorm share)
  trunk      conv2 + bn2 + the long skip
  up0        subpixel stage 0: conv 64->256, pixel shuffle, PReLU
  up1        subpixel stage 1's conv, before its shuffle
  head       the 9x9 64->3 conv at 4x, direct
  head_folded  the same conv partially folded (the JAX package's and,
             where faster, the port's form): on the last stage's
             (2x, 256) pre-shuffle map
  adam       the pretrain's Adam step on zero gradients
  synth      on-device LR/HR pair synthesis
  gen_fwd / gen_fwd_bwd   the whole generator
  full_step_eager / full_step_replayed   one eager ``pretrain_step``; one
             ``pretrain_step_multi`` call of K = 1 (a replay)

``step_device_ms`` is the replayed step's ``device_ms``.  The JAX tool's
ablations of how its jitted step threads parameters, statistics and
optimizer state (``core``, ``core_args``, ``stats_only``,
``sgd_nostats``, ``core_sgd``) have no counterpart: the port's step
updates its state in place.  One JSON line on stdout with the card's
name and power limit.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from torchsr_tpu_torch.tools.bench import card, make_trainer
from torchsr_tpu_torch.tools.profile_gan_step import measure


def _fwd_bwd(module, x: torch.Tensor):
    """A call running ``module`` on ``x`` forward and backward, with
    respect to its parameters and ``x``."""
    params = [p for p in module.parameters() if p.requires_grad]

    def call():
        xx = x.detach().requires_grad_(True)
        out = module(xx)
        torch.autograd.grad(out.float().mean(), [xx, *params])

    return call


class _FoldedHead(torch.nn.Module):
    """The generator's 9x9 head on a pre-shuffle map, partially folded
    (its own parameters, so ``_fwd_bwd`` differentiates them)."""

    def __init__(self, conv3):
        super().__init__()
        self.conv3 = conv3

    def forward(self, y):
        from torchsr_tpu_torch.ops.subpixel_conv import (
            conv_head_partially_folded,
        )

        return conv_head_partially_folded(y, self.conv3.weight,
                                          self.conv3.bias, 4, 2)


def sections(trainer) -> dict:
    """The pretrain step's pieces as calls on seeded inputs."""
    from torchsr_tpu_torch.data.preprocess import synthesize_pair

    gen, opt = trainer.gen, trainer.opt
    gen.train(True)
    gen.compute_dtype = trainer.compute_dtype
    dev, dt = trainer.device, trainer.compute_dtype
    b, lr_hw = trainer.batch_size, trainer.crop_size // 4
    rng = np.random.default_rng(0)

    def mk(*shape, dtype=dt):
        return torch.from_numpy(rng.normal(0, 0.5, shape).astype(
            np.float32)).to(dev, dtype)

    x3, t64 = mk(b, lr_hw, lr_hw, 3), mk(b, lr_hw, lr_hw, 64)
    u64 = mk(b, 2 * lr_hw, 2 * lr_hw, 64)
    h64 = mk(b, 4 * lr_hw, 4 * lr_hw, 64)
    lrimg = mk(b, lr_hw, lr_hw, 3, dtype=torch.float32).abs()
    crops, flips = (torch.from_numpy(a).to(dev)
                    for a in next(iter(trainer.train_loader.epoch(0))))
    zero_grads = {p: torch.zeros_like(p) for p in gen.parameters()}

    class Trunk(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv2 = gen.conv2

        def forward(self, x):
            return self.conv2(x) + x

    def adam():
        for p, g in zero_grads.items():
            p.grad = g
        opt.psnr.step()

    def gen_fwd():
        with torch.no_grad():
            trainer._generate(lrimg, True)

    def gen_fwd_bwd():
        gen.zero_grad(set_to_none=True)
        trainer._generate(lrimg, True).mean().backward()

    return {
        "conv1": _fwd_bwd(gen.conv1, x3),
        "tower": _fwd_bwd(gen.blocks, t64),
        "bn1": _fwd_bwd(gen.blocks[0].bn1, t64),
        "trunk": _fwd_bwd(Trunk(), t64),
        "up0": _fwd_bwd(gen.conv_layers[0], t64),
        "up1": _fwd_bwd(gen.conv_layers[1].conv, u64),
        "head": _fwd_bwd(gen.conv3, h64),
        "head_folded": _fwd_bwd(_FoldedHead(gen.conv3),
                                mk(b, 2 * lr_hw, 2 * lr_hw, 256)),
        "adam": adam,
        "synth": lambda: synthesize_pair(crops, flips, trainer.upscale),
        "gen_fwd": gen_fwd, "gen_fwd_bwd": gen_fwd_bwd,
        "full_step_eager": lambda: trainer.pretrain_step(crops, flips),
        "full_step_replayed": lambda: trainer.pretrain_step_multi(
            crops[None], flips[None]),
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--crop", type=int, default=96)
    parser.add_argument("--reps", type=int, default=8)
    parser.add_argument("--components", default="",
                        help="comma-separated subset (default: all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pretrain needs a CUDA card")
    only = set(filter(None, args.components.split(",")))
    trainer = make_trainer("srgan", args.batch, args.crop, "cuda")
    fns = {k: v for k, v in sections(trainer).items()
           if not only or k in only}
    rows = measure(fns, args.reps)
    row = {"tool": "profile_pretrain", "model": "srgan",
           "batch": args.batch, "crop": args.crop,
           "dtype": str(trainer.compute_dtype), "reps": args.reps,
           **card("cuda"), "components": rows}
    if "full_step_replayed" in rows:
        row["step_device_ms"] = rows["full_step_replayed"]["device_ms"]
    from torchsr_tpu_torch.models.srgan import FUSED_HEAD_ON_CUDA

    parts = ("conv1", "tower", "trunk", "up0", "up1",
             "head_folded" if FUSED_HEAD_ON_CUDA else "head", "adam",
             "synth")
    if all(p in rows for p in parts):
        row["sum_sections_device_ms"] = sum(rows[p]["device_ms"]
                                            for p in parts)
    if "bn1" in rows:
        row["bn_share_device_ms"] = 33 * rows["bn1"]["device_ms"]
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
