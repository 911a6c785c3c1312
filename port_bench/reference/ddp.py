"""The data-parallel GAN step's reference: the recipe's step (``reference/
training.py``) on the global batch, every rank's rows at once.

A data-parallel step of the port on R ranks of B rows each averages the
ranks' gradients of their own losses, each loss a mean over the rank's
B rows whose relativistic terms compare against means over all R x B
rows, with every BatchNorm's statistics over the R x B rows.  The
average of those per-rank losses is the recipe's loss on the R x B rows,
and the averaged gradient is its gradient: so the reference is the
plain step (``training.gan_step``'s order and losses, f32) on the global
batch, and the losses it reports are the ranks' mean.

To fit one card, the generator runs in chunks of ``chunk`` rows: its
forward without gradients to make sr for the discriminator's step and
the generator's loss, then, once the loss's gradient with respect to sr
is known, each chunk's forward again with its backward from that
gradient, the parameters' gradients summed over the chunks.  The
generator has no BatchNorm and no term across rows, so this is the same
gradient in another summation order.

``run_ranks`` instead keeps each rank's weights and Adam apart, rank r's
rows through rank r's weights, the BatchNorm statistics and the
relativistic means still over every row: a rank's own gradient is then
that of the sum of the ranks' losses through its own rows, as the
port's differentiable all-reduces give it.  With the gradients averaged
(``exchange``) it is the plain step again, in another order; without,
it is the fault "the gradient exchange left out", each rank stepping on
its own gradient.  ``run_steps``'s ``fault`` plants that fault or a
half batch.
"""

from __future__ import annotations

import torch

from port_bench.reference import esrgan, ops, pairs
from port_bench.reference.training import (
    Adam,
    Model,
    _grads,
    bce_logits,
    l1,
)


def gan_step(model: Model, g: dict, d: dict, v: dict, opt_g: Adam,
             opt_d: Adam, lr_img, hr, record: dict,
             chunk: int) -> tuple[float, float]:
    """ESRGAN's relativistic GAN step on the whole batch, the generator
    in chunks (module docstring); as ``training.gan_step``."""
    lrs = lr_img.split(chunk)
    with torch.no_grad():
        sr = torch.cat([model.gen(g, x) for x in lrs])
    real, fake = model.disc(d, hr), model.disc(d, sr)
    loss_d = (bce_logits(real - fake.mean(), 1.0)
              + bce_logits(fake - real.mean(), 0.0)) / 2.0
    gd = _grads(loss_d, d)
    opt_d.step(gd)
    record["d"] = gd
    sr = sr.requires_grad_(True)
    with torch.no_grad():
        feat_hr = model.vgg(v, hr)
    content = l1(model.vgg(v, sr), feat_hr)
    weights = model.cfg["losses"]["gan"]
    fake = model.disc(d, sr)
    with torch.no_grad():
        real = model.disc(d, hr)
    adv = bce_logits(fake - real.mean(), 1.0)
    loss_g = weights["l1"] * l1(sr, hr) + content + weights["adv"] * adv
    (d_sr,) = torch.autograd.grad(loss_g, [sr])
    keys = list(g)
    gg = {k: torch.zeros_like(g[k]) for k in keys}
    for x, dy in zip(lrs, d_sr.split(chunk)):
        part = torch.autograd.grad(model.gen(g, x), [g[k] for k in keys],
                                   grad_outputs=dy, allow_unused=True)
        for k, t in zip(keys, part):
            if t is not None:
                gg[k] += t
    opt_g.step(gg)
    record["g"] = gg
    return float(loss_d.detach()), float(loss_g.detach())


def run_steps(cfg: dict, weights: dict, batches: list, *, lr: float,
              chunk: int, prec: str = "f32", vgg_convs: int | None = None,
              fault: str | None = None) -> dict:
    """``training.run_steps`` for the GAN phase on global batches, the
    generator in chunks of ``chunk`` rows: each step's losses, every
    leaf's first gradient and its change over the steps.  ``fault``:
    ``"half_batch"`` takes each step over the first half of its rows,
    ``"half_batch_late"`` does so from the second step on (the replayed
    steps), ``"no_exchange"`` runs ``run_ranks`` on ranks of ``chunk``
    rows without averaging their gradients."""
    if fault == "no_exchange":
        return run_ranks(cfg, weights, batches, lr=lr,
                         world=len(batches[0][0]) // chunk, exchange=False,
                         prec=prec, vgg_convs=vgg_convs)
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
        losses.append(gan_step(model, g, d, v, opt_g, opt_d, lr_img, hr,
                               record, chunk))
        if grad1 is None:
            grad1 = {o: {k: float(t.norm()) for k, t in gs.items()}
                     for o, gs in record.items()}
    live = {"g": g, "d": d}
    change = {o: {k: float((live[o][k].detach() - start[o][k]).norm())
                  for k in grad1[o]} for o in grad1}
    return {"losses": losses, "grad1": grad1, "change": change}


def disc_ranks(model: Model, ds: list, x: torch.Tensor) -> torch.Tensor:
    """ESRGAN's discriminator (``esrgan.discriminator``) on the global
    batch, rank r's share of the rows through rank r's weights
    ``ds[r]``, every BatchNorm's statistics over all rows."""
    cfg, prec = model.cfg["disc"], model.prec
    hs = list(x.chunk(len(ds)))
    for conv_i, bn_i, _ci, _co, stride in esrgan._disc_layout(cfg["stages"]):
        hs = [ops.conv(h, w[f"features.{conv_i}.weight"],
                       w.get(f"features.{conv_i}.bias"), prec, stride)
              for w, h in zip(ds, hs)]
        if bn_i is not None:
            h = torch.cat(hs)
            mean = h.mean(dim=(0, 2, 3), keepdim=True)
            var = (h - mean).square().mean(dim=(0, 2, 3), keepdim=True)
            inv = torch.rsqrt(var + 1e-5)
            hs = [(h - mean) * inv
                  * w[f"features.{bn_i}.weight"][None, :, None, None]
                  + w[f"features.{bn_i}.bias"][None, :, None, None]
                  for w, h in zip(ds, hs)]
        hs = [ops.lrelu(h, cfg["lrelu_slope"]) for h in hs]
    out = []
    for w, h in zip(ds, hs):
        h = ops.lrelu(ops.dense(h.flatten(1), w["classifier.0.weight"],
                                w["classifier.0.bias"], prec),
                      cfg["lrelu_slope"])
        out.append(ops.dense(h, w["classifier.2.weight"],
                             w["classifier.2.bias"], prec))
    return torch.cat(out)


def _step_ranks(opts: list, grads: list, exchange: bool) -> dict:
    """Each rank's Adam step on its gradient, or on the ranks' mean if
    ``exchange``; rank 0's gradient returned."""
    if exchange:
        mean = {k: torch.stack([gr[k] for gr in grads]).mean(0)
                for k in grads[0]}
        grads = [mean] * len(grads)
    for opt, gr in zip(opts, grads):
        opt.step(gr)
    return grads[0]


def run_ranks(cfg: dict, weights: dict, batches: list, *, lr: float,
              world: int, exchange: bool = True, prec: str = "f32",
              vgg_convs: int | None = None) -> dict:
    """``run_steps`` with ``world`` ranks' weights and optimizers apart
    (module docstring): each step's losses (the ranks' mean), rank 0's
    first gradients and changes."""
    model = Model(cfg, prec, vgg_convs)
    adam = cfg["adam"]

    def copies(part: str) -> list:
        return [{k: t.detach().clone().requires_grad_(True)
                 for k, t in weights[part].items()} for _ in range(world)]

    gs, ds = copies("g"), copies("d")
    v = {k: t.detach() for k, t in weights["v"].items()}
    opts_g = [Adam(g, lr, adam["betas"], adam["eps"]) for g in gs]
    opts_d = [Adam(d, lr, adam["betas"], adam["eps"]) for d in ds]
    start = {"g": {k: t.detach().clone() for k, t in weights["g"].items()},
             "d": {k: t.detach().clone() for k, t in weights["d"].items()}}
    losses, grad1 = [], None
    for crops, flips in batches:
        lr_img, hr = pairs.synthesize(crops, flips, cfg["scale"])
        lrs = lr_img.chunk(world)
        with torch.no_grad():
            sr = torch.cat([model.gen(g, x) for g, x in zip(gs, lrs)])
        real, fake = disc_ranks(model, ds, hr), disc_ranks(model, ds, sr)
        loss_d = (bce_logits(real - fake.mean(), 1.0)
                  + bce_logits(fake - real.mean(), 0.0)) / 2.0
        got = iter(torch.autograd.grad(world * loss_d,
                                       [t for d in ds for t in d.values()]))
        record = {"d": _step_ranks(opts_d, [{k: next(got) for k in d}
                                            for d in ds], exchange)}
        sr = sr.requires_grad_(True)
        with torch.no_grad():
            feat_hr = model.vgg(v, hr)
        content = l1(model.vgg(v, sr), feat_hr)
        fake = disc_ranks(model, ds, sr)
        with torch.no_grad():
            real = disc_ranks(model, ds, hr)
        adv = bce_logits(fake - real.mean(), 1.0)
        lw = cfg["losses"]["gan"]
        loss_g = lw["l1"] * l1(sr, hr) + content + lw["adv"] * adv
        (d_sr,) = torch.autograd.grad(world * loss_g, [sr])
        gg = []
        for g, x, dy in zip(gs, lrs, d_sr.chunk(world)):  # a rank at a time
            part = torch.autograd.grad(model.gen(g, x), list(g.values()),
                                       grad_outputs=dy, allow_unused=True)
            gg.append({k: torch.zeros_like(g[k]) if t is None else t
                       for k, t in zip(g, part)})
        record["g"] = _step_ranks(opts_g, gg, exchange)
        losses.append((float(loss_d.detach()), float(loss_g.detach())))
        if grad1 is None:
            grad1 = {o: {k: float(t.norm()) for k, t in gr.items()}
                     for o, gr in record.items()}
    live = {"g": gs[0], "d": ds[0]}
    change = {o: {k: float((live[o][k].detach() - start[o][k]).norm())
                  for k in grad1[o]} for o in grad1}
    return {"losses": losses, "grad1": grad1, "change": change}
