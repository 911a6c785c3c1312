"""Component profile of the GAN step on one CUDA card.

    python -m torchsr_tpu_torch.tools.profile_gan_step [--model esrgan|srgan]
        [--batch N] [--crop N] [--reps 8] [--components a,b,c]

The port of the JAX package's ``tools/profile_gan_step.py``: the
trainer's GAN step (``train/trainer.py``) taken apart into the pieces
that have a counterpart here, each timed two ways on the card:
``chained_ms``, CUDA events around ``--reps`` chained calls divided by
the count (the device timeline a call takes, idle gaps included; two
phases, the second kept), and under ``torch.profiler`` ``device_ms`` (the
sum of its kernels' durations a call), ``kernels`` a call and
``busy_share`` (the device's busy share of the span from the first
kernel to the last).

Components:
  gen_fwd        generator forward (train mode, RDB kernels for ESRGAN)
  gen_fwd_bwd    generator forward + backward (parameter gradients)
  disc_fwd       one discriminator forward (train mode, BN statistics)
  dloss_fwd_bwd  the discriminator loss: two forwards + backward
  vgg_fwd        one VGG19 relu5_4 forward
  vgg_fwd_bwd    VGG forward + backward with respect to its input
  head_fwd_bwd   the generator loss's head: VGG(sr) + VGG(hr) + D(hr) +
                 D(sr), gradient with respect to sr
  adam3          the three Adam steps (fused, capturable) on zero
                 gradients
  synth          on-device LR/HR pair synthesis
  full_step_eager     one eager ``gan_step``
  full_step_replayed  one ``gan_step_multi`` call of K = 1: a replay of
                      the captured step (the first call captures it)

``step_device_ms`` is the replayed step's ``device_ms``.  The JAX tool's
probes of its per-leaf state passing through ``jit`` (``statepass*``,
``packedpass_noop``, ``packcost``, ``full_step_packed``) have no
counterpart: PyTorch updates the state in place and passes none.  One
JSON line on stdout with the card's name and power limit.  It needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from torchsr_tpu_torch.tools.bench import card, make_trainer
from torchsr_tpu_torch.tools.bench_rdb import _profile


def chained_ms(fn, reps: int) -> float:
    """CUDA-event milliseconds a call of ``fn`` over ``reps`` chained
    calls, after one; two phases, the second kept."""
    fn()
    torch.cuda.synchronize()
    for _phase in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(fns: dict, reps: int) -> dict:
    """Each named call's ``chained_ms``, and under the profiler
    (``tools/bench_rdb.py``'s window of 3 calls after one) its device
    ms, device events and busy share a call."""
    rows = {}
    for name, fn in fns.items():
        prof = _profile(torch, fn, 3)
        rows[name] = {"chained_ms": chained_ms(fn, reps),
                      "device_ms": prof["device_ms"],
                      "kernels": prof["kernels_per_call"],
                      "busy_share": prof["busy_share_of_span"]}
    return rows


def components(trainer) -> dict:
    """The GAN step's pieces as calls on seeded inputs."""
    from torchsr_tpu_torch.data.preprocess import synthesize_pair
    from torchsr_tpu_torch.train import losses as L

    gen, disc, vgg, opt = trainer.gen, trainer.disc, trainer.vgg, trainer.opt
    dev, b, crop = trainer.device, trainer.batch_size, trainer.crop_size
    rng = np.random.default_rng(0)
    lr_img = torch.from_numpy(
        rng.random((b, crop // 4, crop // 4, 3), dtype=np.float32)).to(dev)
    hr_img = torch.from_numpy(
        rng.random((b, crop, crop, 3), dtype=np.float32)).to(dev)
    crops, flips = (torch.from_numpy(a).to(dev)
                    for a in next(iter(trainer.train_loader.epoch(0))))
    with torch.no_grad():
        feat_hr = vgg(hr_img)
    zero_grads = {p: torch.zeros_like(p)
                  for m in (gen, disc) for p in m.parameters()}

    def gen_fwd():
        with torch.no_grad():
            trainer._generate(lr_img, True)

    def gen_fwd_bwd():
        gen.zero_grad(set_to_none=True)
        trainer._generate(lr_img, True).mean().backward()

    def disc_fwd():
        with torch.no_grad():
            disc(hr_img)

    def dloss_fwd_bwd():
        disc.zero_grad(set_to_none=True)
        trainer._disc_loss(disc(hr_img), disc(hr_img)).backward()

    def vgg_fwd():
        with torch.no_grad():
            vgg(hr_img)

    def vgg_fwd_bwd():
        x = hr_img.clone().requires_grad_(True)
        torch.autograd.grad(L.l1_loss(vgg(x), feat_hr), x)

    def head_fwd_bwd():
        sr = hr_img.clone().requires_grad_(True)
        disc.requires_grad_(False)
        try:
            with torch.no_grad():
                feat = vgg(hr_img)
            content = L.l1_loss(vgg(sr), feat)
            torch.autograd.grad(trainer._gen_loss(sr, hr_img, content), sr)
        finally:
            disc.requires_grad_(True)

    def adam3():
        for p, g in zero_grads.items():
            p.grad = g
        for o in opt.all():
            o.step()

    def synth():
        synthesize_pair(crops, flips, trainer.upscale)

    return {"gen_fwd": gen_fwd, "gen_fwd_bwd": gen_fwd_bwd,
            "disc_fwd": disc_fwd, "dloss_fwd_bwd": dloss_fwd_bwd,
            "vgg_fwd": vgg_fwd, "vgg_fwd_bwd": vgg_fwd_bwd,
            "head_fwd_bwd": head_fwd_bwd, "adam3": adam3, "synth": synth,
            "full_step_eager": lambda: trainer.gan_step(crops, flips, 1e-4,
                                                        1e-4),
            "full_step_replayed": lambda: trainer.gan_step_multi(
                crops[None], flips[None], 1e-4, 1e-4)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", default="esrgan",
                        choices=["esrgan", "srgan"])
    parser.add_argument("--batch", type=int, default=0,
                        help="default: 32 for esrgan, 128 for srgan")
    parser.add_argument("--crop", type=int, default=0,
                        help="default: 128 for esrgan, 96 for srgan")
    parser.add_argument("--reps", type=int, default=8)
    parser.add_argument("--components", default="",
                        help="comma-separated subset (default: all)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gan_step needs a CUDA card")
    esr = args.model == "esrgan"
    batch = args.batch or (32 if esr else 128)
    crop = args.crop or (128 if esr else 96)
    only = set(filter(None, args.components.split(",")))
    trainer = make_trainer(args.model, batch, crop, "cuda")
    fns = {k: v for k, v in components(trainer).items()
           if not only or k in only}
    rows = measure(fns, args.reps)
    row = {"tool": "profile_gan_step", "model": args.model, "batch": batch,
           "crop": crop, "dtype": str(trainer.compute_dtype), "reps":
           args.reps, **card("cuda"), "components": rows}
    if "full_step_replayed" in rows:
        row["step_device_ms"] = rows["full_step_replayed"]["device_ms"]
    parts = ("gen_fwd_bwd", "dloss_fwd_bwd", "head_fwd_bwd", "adam3",
             "synth")
    if all(p in rows for p in parts):
        row["sum_components_device_ms"] = sum(rows[p]["device_ms"]
                                              for p in parts)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
