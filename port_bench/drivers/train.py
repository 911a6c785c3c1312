"""Training cells: the port's trainer fed through its prefetcher.

Set-up makes the crops of one epoch in host RAM from the seed
(``generate.Crops``), builds the model's trainer (``train/trainer.py``)
on the card, copies the benchmark's seeded weights into its generator,
discriminator and VGG19, and drives its first steps through the
window's own call and feed (``data/prefetch.py``
``prefetch_to_device_stacked`` into ``gan_step_multi`` /
``pretrain_step_multi``, each call K replays of the captured step): a
call of step 1 alone, which the trainer runs eagerly as the capture's
warm-up before it captures the step, and whose Adam state gives each
leaf's first gradient; a call of steps 2 and 3, the first two replays,
after which each leaf's change is read; one call of K steps, so that
every allocation the window makes has been made once.
Each of these steps takes other rows.  The window then calls the
trainer K steps at a time, each call's stacked batch from the
prefetcher, until ``--seconds`` have passed, and ends on the readback
of every step's losses.  ``train_crops_per_s`` is the window's crops
over its seconds.

The check: steps 1-3 again in the reference, f32 with TF32 off, from
the same weights and rows, once the trainer is freed
(``compare.training``).  The traced slice (``--trace 1``) profiles the
cell's number of whole calls after the window.
"""

from __future__ import annotations

import gc
import importlib
import threading
import time
from argparse import Namespace

import numpy as np
import torch

from port_bench import compare, generate, harness, trace, weights
from port_bench.reference import ops, training, vgg


class QuietLogger:
    """The trainer's logger, printing to standard error (standard
    output carries only the result), with no metrics sink."""

    active = False
    logs_images = False

    def log(self, statement: str) -> None:
        harness.log(f"trainer: {statement}")

    def log_metrics(self, contents: dict, step=None) -> None:
        pass

    def log_image(self, key: str, image) -> None:
        pass

    def finish(self) -> None:
        pass


def model_weights(cfg: dict, mix: dict, seed: int, device,
                  vgg_convs=None) -> dict:
    ref = importlib.import_module(f"port_bench.reference.{cfg['family']}")
    return {
        "g": weights.make(ref.generator_specs(cfg), seed, "generator", device),
        "d": weights.make(ref.discriminator_specs(cfg, mix["crop"]), seed,
                          "discriminator", device),
        "v": weights.make(vgg.specs(cfg, vgg_convs), seed, "vgg", device)}


def build_trainer(r, mix: dict, w: dict):
    from torchsr_tpu_torch.train.state import set_lr
    from torchsr_tpu_torch.train.trainer import ESRGANTrainer, SRGANTrainer

    cfg = r.config
    depth = cfg.get("num_rrdb", cfg.get("num_residual"))
    args = Namespace(
        batch_size=mix["batch"], disable_amp=False, epochs=1,
        pretrain_epochs=1, gan_checkpoint=None, psnr_checkpoint=None,
        seed=0, skip_image_save=True, model=cfg["family"],
        num_residual=depth, vgg_convs=cfg.get("vgg_convs"),
        metrics_file=None, vgg_weights=None,
        steps_per_call=mix.get("steps_per_call", 0),
        no_preempt_save=True, sync_saves=True, upscale_factor=cfg["scale"])
    loader = generate.Loader(mix["batch"], mix["crop"],
                            mix["batches_per_epoch"])
    cls = {"esrgan": ESRGANTrainer, "srgan": SRGANTrainer}[cfg["family"]]
    trainer = cls(args, loader, loader, loader.dataset_len,
                  loader.dataset_len, device=r.device, logger=QuietLogger())
    weights.load_into(trainer.gen, w["g"])
    weights.load_into(trainer.disc, w["d"])
    weights.load_into(trainer.vgg, w["v"])
    if mix["phase"] == "pretrain":
        set_lr(trainer.opt.psnr, mix["lr"])
    return trainer


def optimizers(trainer, phase: str) -> dict:
    """Optimizer and module by the reference's names: ``g`` (and ``d``)."""
    if phase == "gan":
        return {"g": (trainer.opt.gen, trainer.gen),
                "d": (trainer.opt.disc, trainer.disc)}
    return {"g": (trainer.opt.psnr, trainer.gen)}


@torch.no_grad()
def first_gradients(trainer, phase: str) -> dict:
    out = {}
    for o, (opt, module) in optimizers(trainer, phase).items():
        beta1 = opt.param_groups[0]["betas"][0]
        names = [n for n, _ in module.named_parameters()]
        # a leaf without Adam state was never stepped: no reading
        norms = [opt.state[p]["exp_avg"].norm() / (1.0 - beta1)
                 if "exp_avg" in opt.state.get(p, {}) else
                 torch.tensor(float("nan"))
                 for _, p in module.named_parameters()]
        out[o] = dict(zip(names, torch.stack([n.cpu() for n in norms])
                          .tolist()))
    return out


@torch.no_grad()
def changes(trainer, phase: str, start: dict) -> dict:
    out = {}
    for o, (_opt, module) in optimizers(trainer, phase).items():
        named = list(module.named_parameters())
        norms = torch.stack([(p - start[o][n]).norm() for n, p in named])
        out[o] = dict(zip([n for n, _ in named], norms.tolist()))
    return out


def run(r: "harness.Run") -> "harness.Outcome":
    from torchsr_tpu_torch.data.prefetch import prefetch_to_device_stacked

    cfg, mix, dev = r.config, r.traffic, r.device
    phase, lr = mix["phase"], mix["lr"]
    data = generate.Crops(mix, r.seed)
    harness.log(f"setup: crops made at "
                f"{time.perf_counter() - r.t_start:.3f} s")
    w = model_weights(cfg, mix, r.seed, dev, cfg.get("vgg_convs"))
    harness.log(f"setup: weights made at "
                f"{time.perf_counter() - r.t_start:.3f} s")
    trainer = build_trainer(r, mix, w)
    harness.log(f"setup: trainer built at "
                f"{time.perf_counter() - r.t_start:.3f} s")
    if "after_build" in r.hooks:
        r.hooks["after_build"](trainer)
    k = (trainer.gan_steps_per_call if phase == "gan"
         else trainer.steps_per_call)
    spans = trace.Spans()

    def call(kind: str, batch: tuple) -> torch.Tensor:
        crops, flips = batch
        if kind == "single":
            crops, flips = crops[None], flips[None]
        with spans("step.call"):
            if phase == "gan":
                out = trainer.gan_step_multi(crops, flips, lr, lr)
                return torch.stack([out["disc_loss"], out["gen_loss"]], 1)
            return trainer.pretrain_step_multi(crops, flips)[:, None]

    def feed(start: int, stop=None, group: int = k, stop_event=None):
        return prefetch_to_device_stacked(
            data.stream(start, stop, stop_event), dev, group)

    first = [call(*item) for item in feed(0, 1)]           # step 1
    grad1 = first_gradients(trainer, phase)
    harness.log(f"setup: step 1 (and the capture) done at "
                f"{time.perf_counter() - r.t_start:.3f} s")
    second = [call(*item) for item in feed(1, 3, 2)]       # steps 2-3
    change = changes(trainer, phase, w)
    early = torch.cat(first + second).cpu().tolist()
    stop = threading.Event()
    stream = feed(3, stop_event=stop)
    warm = call(*next(stream))                             # one K-step call
    float(warm[-1, -1])

    t_window = time.perf_counter()
    setup_s = t_window - r.t_start
    waits, outs = [], []
    while True:
        t0 = time.perf_counter()
        with spans("prefetch.next"):
            item = next(stream)
        waits.append(time.perf_counter() - t0)
        outs.append(call(*item))
        if time.perf_counter() - t_window >= r.seconds:
            break
    losses = torch.cat(outs).cpu().numpy()                 # the readback
    window_s = time.perf_counter() - t_window
    steps, n_calls = len(losses), len(outs)
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    failed = int((~np.isfinite(losses)).any(axis=1).sum())
    notes = [f"train: {n_calls} calls, {steps} steps of {mix['batch']} in "
             f"{window_s:.3f} s, {failed} with a non-finite loss; set-up "
             f"{setup_s:.3f} s; peak {memory_peak} bytes"]
    sliced = None
    if r.trace:
        calls = r.cell["slice"]["calls"]

        def run_slice():
            last = None
            for _ in range(calls):
                with spans("prefetch.next"):
                    item = next(stream)
                last = call(*item)
            with spans("readback"):
                float(last[-1, -1])

        sliced = trace.profile(
            run_slice, units=calls * k,
            families=r.cell["slice"]["families"],
            calls=calls, spans=spans, device=dev)
    stop.set()
    for _ in stream:  # the producer ends; its thread is joined
        pass
    del trainer, stream, outs, first, second, warm
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    batches = [tuple(torch.from_numpy(a).to(dev) for a in data.batch(j))
               for j in range(3)]
    with ops.exact_f32():
        ref = training.run_steps(cfg, w, batches, phase=phase, lr=lr,
                                 vgg_convs=cfg.get("vgg_convs"))
    got = {"losses": early, "grad1": grad1, "change": change}
    values = compare.training(got, ref)
    notes.append(f"train: reference of 3 steps in "
                 f"{time.perf_counter() - t_ref:.3f} s; leaves left out of "
                 f"the norm gaps: {compare.excluded(ref)}")
    notes.append(f"train: losses of steps 1-3, port {early}, reference "
                 f"{ref['losses']}")
    notes.append(f"train: worst leaves {compare.worst_leaves(got, ref)}")
    notes.append(f"train: numbers {values}")
    checks = harness.checks_from(values, r.cell["check"]["limits"])
    window = {"seconds": window_s, "steps": steps, "batch": mix["batch"],
              "crop": mix["crop"], "phase": phase, "input_wait_s": waits}
    return harness.Outcome(
        setup_s=setup_s,
        end_to_end={"train_crops_per_s": (steps * mix["batch"] / window_s,
                                          "crops/s"),
                    "device_peak_gib": (memory_peak / 2 ** 30, "GiB")},
        window=window, checks=checks, attempted=steps, failed=failed,
        memory_peak_bytes=memory_peak, slice=sliced, notes=notes)
