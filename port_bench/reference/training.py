"""The training steps of the recipe, plain f32, and what the benchmark
reads from them.

Losses (means over every element): L1, MSE; BCE on logits
``max(x, 0) - x t + log(1 + exp(-|x|))``; BCE on probabilities (log
clamped at -100, as ``nn.BCELoss``).  ESRGAN's relativistic-average
GAN (arXiv:1809.00219, eq. 1-2): the discriminator's loss
``[BCEwL(D(hr) - mean D(sr), 1) + BCEwL(D(sr) - mean D(hr), 0)] / 2``,
the generator's ``0.01 L1(sr, hr) + L1(VGG(sr), VGG(hr)) + 0.005
BCEwL(D(sr) - mean D(hr), 1)``.  A GAN step runs, in order: the
generator forward; the discriminator on hr and on the detached sr, its
loss, its Adam step; the generator's loss against the updated
discriminator (on hr, without gradient, then on sr); the generator's
Adam step.  The PSNR pretrain step: the pixel loss (L1 for ESRGAN, MSE
for SRGAN) and the generator's Adam step.  Adam (Kingma & Ba) with
bias correction: ``p -= lr * m_hat / (sqrt(v_hat) + eps)``.

``run_steps`` drives a few steps from given weights and batches and
returns each step's losses, every leaf's first gradient and every
leaf's change after the steps: the numbers the check compares.
"""

from __future__ import annotations

import importlib

import torch

from port_bench.reference import ops, pairs, vgg


def l1(a, b):
    return (a - b).abs().mean()


def mse(a, b):
    return (a - b).square().mean()


def bce_logits(x, t: float):
    return (x.clamp_min(0.0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def bce_probs(p, t: float):
    return -(t * torch.log(p).clamp_min(-100.0)
             + (1.0 - t) * torch.log1p(-p).clamp_min(-100.0)).mean()


class Adam:
    """Adam over a dict of leaf tensors, updated in place."""

    def __init__(self, params: dict, lr: float, betas, eps: float):
        self.params, self.lr, self.eps = params, lr, eps
        self.b1, self.b2 = betas
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (self.v[k] / bc2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def _grads(loss, params: dict) -> dict:
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys])
    return dict(zip(keys, gs))


class Model:
    """A configuration's nets (``reference/<family>.py``) over weight
    dicts, at one precision."""

    def __init__(self, cfg: dict, prec: str, vgg_convs: int | None = None):
        self.cfg, self.prec, self.vgg_convs = cfg, prec, vgg_convs
        self.net = importlib.import_module(
            f"port_bench.reference.{cfg['family']}")

    def gen(self, w, x):
        return self.net.generator(w, x, self.cfg, self.prec)

    def disc(self, w, x):
        return self.net.discriminator(w, x, self.cfg, self.prec)

    def vgg(self, w, x):
        return vgg.features(w, x, self.cfg, self.prec, self.vgg_convs)


def gan_step(model: Model, g: dict, d: dict, v: dict, opt_g: Adam,
             opt_d: Adam, lr_img, hr, record: dict) -> tuple[float, float]:
    """One adversarial step (module docstring); ESRGAN's relativistic
    losses, or SRGAN's ``VGG-L1 + 0.001 BCE(D(sr), 1)``.  Returns
    (disc_loss, gen_loss); ``record`` gets each optimizer's gradients of
    the step under ``"g"`` and ``"d"``."""
    relativistic = model.cfg["losses"]["gan"]["kind"] == "relativistic_average"
    sr = model.gen(g, lr_img)
    real, fake = model.disc(d, hr), model.disc(d, sr.detach())
    if relativistic:
        loss_d = (bce_logits(real - fake.mean(), 1.0)
                  + bce_logits(fake - real.mean(), 0.0)) / 2.0
    else:
        loss_d = bce_probs(real, 1.0) + bce_probs(fake, 0.0)
    gd = _grads(loss_d, d)
    opt_d.step(gd)
    record["d"] = gd
    with torch.no_grad():
        feat_hr = model.vgg(v, hr)
    content = l1(model.vgg(v, sr), feat_hr)
    weights = model.cfg["losses"]["gan"]
    fake = model.disc(d, sr)
    if relativistic:
        with torch.no_grad():
            real = model.disc(d, hr)
        adv = bce_logits(fake - real.mean(), 1.0)
        loss_g = weights["l1"] * l1(sr, hr) + content + weights["adv"] * adv
    else:
        loss_g = content + weights["adv"] * bce_probs(fake, 1.0)
    gg = _grads(loss_g, g)
    opt_g.step(gg)
    record["g"] = gg
    return float(loss_d.detach()), float(loss_g.detach())


def pretrain_step(model: Model, g: dict, opt: Adam, lr_img, hr,
                  record: dict) -> tuple[float]:
    sr = model.gen(g, lr_img)
    loss = (l1 if model.cfg["losses"]["pixel"] == "l1" else mse)(sr, hr)
    gg = _grads(loss, g)
    opt.step(gg)
    record["g"] = gg
    return (float(loss.detach()),)


def run_steps(cfg: dict, weights: dict, batches: list, *, phase: str,
              lr: float, prec: str = "f32", vgg_convs: int | None = None,
              fault: str | None = None) -> dict:
    """``len(batches)`` steps of ``phase`` (``gan`` or ``pretrain``) from
    ``weights`` ({"g", "d", "v"}: name -> tensor, copied here) on
    ``batches`` ((uint8 crops, flips) device tensors).  Returns
    ``losses`` (a list a step), ``grad1`` and ``change`` (per optimizer
    ``g``/``d``: leaf name -> norm of the first step's gradient, of the
    leaf's change over the steps).  ``fault="half_batch"`` takes each
    step over the first half of its batch only; ``"half_batch_late"``
    does so from the second step on (the steps that the program runs as
    replays of its captured step)."""
    model = Model(cfg, prec, vgg_convs)
    adam = cfg["adam"]
    g = {k: t.detach().clone().requires_grad_(True)
         for k, t in weights["g"].items()}
    d = {k: t.detach().clone().requires_grad_(True)
         for k, t in weights["d"].items()}
    v = {k: t.detach() for k, t in weights["v"].items()}
    opt_g = Adam(g, lr, adam["betas"], adam["eps"])
    opt_d = Adam(d, lr, adam["betas"], adam["eps"])
    start = {"g": {k: t.detach().clone() for k, t in g.items()},
             "d": {k: t.detach().clone() for k, t in d.items()}}
    losses, grad1 = [], None
    for i, (crops, flips) in enumerate(batches):
        if fault == "half_batch" or (fault == "half_batch_late" and i):
            crops, flips = crops[:len(crops) // 2], flips[:len(flips) // 2]
        lr_img, hr = pairs.synthesize(crops, flips, cfg["scale"])
        record: dict = {}
        if phase == "gan":
            losses.append(gan_step(model, g, d, v, opt_g, opt_d, lr_img, hr,
                                   record))
        else:
            losses.append(pretrain_step(model, g, opt_g, lr_img, hr, record))
        if grad1 is None:
            grad1 = {o: {k: float(t.norm()) for k, t in gs.items()}
                     for o, gs in record.items()}
    live = {"g": g, "d": d}
    change = {o: {k: float((live[o][k].detach() - start[o][k]).norm())
                  for k in grad1[o]} for o in grad1}
    return {"losses": losses, "grad1": grad1, "change": change}
