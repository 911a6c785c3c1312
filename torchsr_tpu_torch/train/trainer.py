"""Two-phase GAN training: a PSNR pretrain, then the GAN phase.

The port of ``torchsr_tpu/train/trainer.py`` (``GANTrainer`` with
``ESRGANTrainer`` and ``SRGANTrainer``), in PyTorch's idiom:
``nn.Module``s with f32 parameters, an explicit compute dtype (bf16 on
CUDA unless ``--disable-amp``; BatchNorm statistics and every loss in
f32; no GradScaler, as bf16 keeps f32's exponent range), three
``torch.optim.Adam`` optimizers, and the learning rate set by the host
once per epoch.  The evaluation generator runs in f32.  The generator
is in ``train()`` mode in the steps (SRGAN's BatchNorms normalize with
batch statistics and update their running ones, JAX's ``train=True``)
and in ``eval()`` mode for the evaluation and the sample render (the
running statistics, JAX's ``train=False``); the discriminator is only
ever run in training mode, as in JAX.

One GAN step follows the JAX ``gan_core`` "vjp" strategy:

1. one generator forward, its graph kept;
2. the discriminator loss on D(hr), then D(``sr.detach()``);
3. the discriminator's Adam step, before the generator loss;
4. the generator loss against the updated discriminator (ESRGAN:
   ``0.01 L1 + VGG-L1 + 0.005 BCEwL(D(sr) - mean D(hr), 1)``, D on hr
   then sr; SRGAN: ``VGG-L1 + 0.001 BCE(D(sr), 1)``, D on sr once),
   the discriminator's BatchNorm running statistics threaded through
   its calls in JAX's order;
5. the backward into the generator through the kept graph.

The production epoch loops run K steps per host call, the port of the
JAX multi-step programs (``pretrain_step_multi``, ``gan_step_multi``;
``--steps-per-call``, default 8 for the pretrain, the model's
``GAN_STEPS_PER_CALL`` for the GAN phase).  On CUDA a call replays one
captured CUDA graph of the step K times (``train/graphs.py``): the
first call of a phase runs its first step eagerly on a side stream and
captures the step after it.  The epoch's ragged tail replays the same
graph once a batch.  On the CPU a K-step call runs K eager steps, with
the same parameters and checkpoints.  While a profiler records, a call
is the span ``train.call`` (``utils/trace.py``; timed on the device,
with ``phase`` and ``k``), its warm-up and capture ``train.capture``,
and each replay ``train.replay``.  ``--fast-compile`` (the JAX
package's shorter XLA compile) changes nothing: the port has no long
compile to shorten, so the trainer logs one line and captures as
without it.  Losses reach the host only when the logger consumes them,
in one transfer a call.  ``--scale`` (2, 4 or 8) sets the generator's
upsample stages and the LR synthesis ratio.

The pretrain loss is L1 for ESRGAN and MSE for SRGAN.  Every residual
dense block of the ESRGAN generator runs the RDB kernels on CUDA
(``ops.rdb``), forward and backward; SRGAN runs no kernel of the port
(the JAX SRGAN reaches no Pallas kernel).  Checkpoints are
``{model}-{phase}-{best,latest}.pth`` in the working directory, with the
whole training state, written by a background thread from a device
snapshot (``utils/checkpoint.py`` ``AsyncCheckpointWriter``; in the
epoch loop under ``--sync-saves``), and the resume priority is the
reference's: an explicit checkpoint, else gan-latest, else psnr-latest
(weights only across phases).

Data parallelism (``torchrun``; ``parallel/mesh.py``): one process a
device, each rank building the state from the seed and taking rank 0's
(one broadcast), training on its shard of every epoch, averaging the
gradients over ranks inside the step (one all-reduce of the flattened
gradients before each optimizer step, which the CUDA graph captures
with the step), with BatchNorm statistics and the relativistic losses'
batch means over the global batch.  Every rank evaluates the whole eval set (so the reports
are one process's); only rank 0 logs, renders and writes checkpoints,
and the ranks meet at a barrier before any checkpoint file is read.

A SIGTERM (``utils/preemption.py``; off under ``--no-preempt-save``)
is read between host calls (under data parallelism, or'd over the
ranks, so that all leave after the same call): the
trainer writes the full ``-latest`` of the running phase, waits for it,
and returns, and a resume re-runs that epoch.
"""

from __future__ import annotations

import os
import time
from argparse import Namespace

import numpy as np
import torch

from torchsr_tpu_torch.data.prefetch import (
    prefetch_to_device,
    prefetch_to_device_stacked,
)
from torchsr_tpu_torch.data.preprocess import (
    synthesize_eval_triple,
    synthesize_pair,
)
from torchsr_tpu_torch.infer.runner import resolve_compute_dtype
from torchsr_tpu_torch.models.esrgan import (
    ESRGANDiscriminator,
    ESRGANGenerator,
)
from torchsr_tpu_torch.models.layers import sync_batchnorm
from torchsr_tpu_torch.models.srgan import (
    SRGANDiscriminator,
    SRGANGenerator,
)
from torchsr_tpu_torch.models.vgg import VGG19Features, load_vgg19_state_dict
from torchsr_tpu_torch.parallel import mesh
from torchsr_tpu_torch.train import losses as L
from torchsr_tpu_torch.train.graphs import StepGraph, warm_up
from torchsr_tpu_torch.train.metrics import mse_per_sample, ssim_per_sample
from torchsr_tpu_torch.train.state import (
    BASE_LR,
    Optimizers,
    set_lr,
    step_lr_schedule,
)
from torchsr_tpu_torch.utils import image_io, trace
from torchsr_tpu_torch.utils.checkpoint import (
    AsyncCheckpointWriter,
    find_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from torchsr_tpu_torch.utils.logging import Logger
from torchsr_tpu_torch.utils.preemption import (
    PreemptionGuard,
    TrainingPreempted,
)
from torchsr_tpu_torch.utils.profiling import StepProfiler

SAMPLE_IMAGE_PATH = os.path.join("media", "waterfalls-low-res.png")
RANDOM_VGG_WARNING = (
    "WARNING: no pretrained VGG19 weights found - the perceptual loss is "
    "using RANDOM VGG features. Results will NOT match the reference "
    "recipe. Pass --vgg-weights (a torchvision vgg19-dcbb9e9d.pth) or "
    "set TORCHSR_VGG_WEIGHTS."
)


class GANTrainer:
    """Shared two-phase trainer machinery; subclasses wire the losses."""

    model_name: str = ""
    # GAN-phase steps per call without --steps-per-call (the JAX
    # package's measured optima: 8, and 2 for ESRGAN).  The JAX ESRGAN
    # runs its K = 2 as an unrolled chain (GAN_MULTI_UNROLL) to dodge
    # XLA's scheduling penalty on a while-loop body; replays of one
    # captured step have no loop body, so the port has no such variant.
    GAN_STEPS_PER_CALL: int = 8

    def __init__(
        self,
        args: Namespace,
        train_loader,
        test_loader,
        train_len: int,
        test_len: int,
        *,
        device: torch.device,
        logger: Logger | None = None,
        dist_ctx: mesh.DistributedContext = mesh.SINGLE,
    ) -> None:
        self.args = args
        self.device = torch.device(device)
        self.world_size = dist_ctx.world_size
        self.main_process = dist_ctx.main_process
        # gradients averaged over a process group (world 1 included)
        self.data_parallel = (dist_ctx.distributed
                              and torch.distributed.is_initialized())
        self.batch_size = args.batch_size
        self.best_psnr = -1.0
        self.epochs = args.epochs
        self.pre_epochs = args.pretrain_epochs
        self.gan_checkpoint = getattr(args, "gan_checkpoint", None)
        self.psnr_checkpoint = getattr(args, "psnr_checkpoint", None)
        self.save_image = not getattr(args, "skip_image_save", False)
        self.train_loader = train_loader
        self.test_loader = test_loader
        self.train_len = train_len
        self.test_len = test_len
        self.upscale = getattr(args, "upscale_factor", 4)
        self.crop_size = train_loader.crop_size
        self.seed = getattr(args, "seed", 0) or 0
        self.step = 0
        self.preempt_save = not getattr(args, "no_preempt_save", False)
        self._preemption: PreemptionGuard | None = None
        self._vote = (mesh.RankVote(self.device) if self.data_parallel
                      else None)
        self.ckpt_writer = (
            None if getattr(args, "sync_saves", False)
            or not self.main_process else AsyncCheckpointWriter())
        self.compute_dtype = resolve_compute_dtype(args, self.device)
        self.logger = logger or Logger(
            config=vars(args),
            metrics_path=getattr(args, "metrics_file", None),
            main_process=self.main_process,
        )
        if getattr(args, "fast_compile", False):
            self.logger.log(
                "--fast-compile: the port has no long compile to shorten "
                "(its kernels are built once and cached); the steps are "
                "captured and replayed as without the flag")
        explicit_k = int(getattr(args, "steps_per_call", 0) or 0)
        self.steps_per_call = explicit_k or 8
        self.gan_steps_per_call = explicit_k or self.GAN_STEPS_PER_CALL
        self.profiler = StepProfiler(
            getattr(args, "profile_steps", 0) or 0,
            getattr(args, "profile_dir", None) or "traces", self.logger,
            device=self.device)
        # captured steps by (phase, batch shape, dtype); CUDA only
        self._graphs: dict = {}
        self._build_models()
        if self.data_parallel:
            for module in (self.gen, self.disc, self.vgg):
                mesh.broadcast_module(module)
            if self.world_size > 1:
                group = torch.distributed.group.WORLD
                sync_batchnorm(self.gen, group)
                sync_batchnorm(self.disc, group)
        self.opt = Optimizers(self.gen, self.disc, device=self.device)
        self._load_sample_image()

    # ---------------------------------------------------------- models

    def _build_models(self) -> None:
        """``self.gen`` and ``self.disc`` (seeded by ``seed`` and
        ``seed + 1``), then ``self._build_vgg()``."""
        raise NotImplementedError

    def _seeded(self, offset: int) -> dict:
        return {"device": self.device, "compute_dtype": self.compute_dtype,
                "generator": torch.Generator().manual_seed(
                    self.seed + offset)}

    def _build_vgg(self) -> None:
        """The perceptual-loss VGG19 trunk (seed + 7): pretrained
        weights where given or found, else seeded random features."""
        self.vgg = VGG19Features(
            getattr(self.args, "vgg_convs", None), **self._seeded(7),
        ).requires_grad_(False)
        vgg_path = getattr(self.args, "vgg_weights", None)
        explicit = bool(vgg_path)
        if not vgg_path:
            vgg_path = discover_vgg_weights()
            if vgg_path:
                self.logger.log(f"Auto-discovered VGG19 weights: {vgg_path}")
        self.vgg_pretrained = False
        if vgg_path and os.path.exists(vgg_path):
            load_vgg19_state_dict(self.vgg, _load_vgg_weights(vgg_path))
            self.logger.log(f"Loaded VGG19 weights from {vgg_path}")
            self.vgg_pretrained = True
        elif explicit:
            raise FileNotFoundError(
                f"--vgg-weights file not found: {vgg_path}")

    def _pixel_loss(self, sr, hr):
        raise NotImplementedError

    def _disc_loss(self, real, fake):
        raise NotImplementedError

    def _gen_loss(self, sr, hr, content):
        """The generator's loss from ``sr`` (with its graph), ``hr`` and
        the perceptual term, against the current discriminator."""
        raise NotImplementedError

    def _generate(self, lr_img: torch.Tensor, train: bool) -> torch.Tensor:
        """The generator in training mode and the training compute
        dtype, or in eval mode and f32 for evaluation (the JAX
        ``gen_eval`` has no dtype and runs ``train=False``)."""
        self.gen.train(train)
        self.gen.compute_dtype = self.compute_dtype if train else None
        return self.gen(lr_img)

    # ----------------------------------------------------------- steps

    def _pretrain_body(self, crops_u8: torch.Tensor,
                       flips: torch.Tensor) -> torch.Tensor:
        """One PSNR-phase step on a device batch; returns the loss as a
        (1,) tensor.  What a graph captures: no host value, no sync."""
        lr_img, hr_img = synthesize_pair(crops_u8, flips, self.upscale)
        self.opt.psnr.zero_grad(set_to_none=True)
        loss = self._pixel_loss(self._generate(lr_img, True), hr_img)
        loss.backward()
        self._average_gradients(self.gen)
        self.opt.psnr.step()
        return loss.detach().reshape(1)

    def _gan_body(self, crops_u8: torch.Tensor,
                  flips: torch.Tensor) -> torch.Tensor:
        """One adversarial step (module docstring) at the learning rates
        the optimizers hold; returns (disc_loss, gen_loss) as a (2,)
        tensor.  What a graph captures."""
        lr_img, hr_img = synthesize_pair(crops_u8, flips, self.upscale)
        sr = self._generate(lr_img, True)

        self.disc.requires_grad_(True)
        self.opt.disc.zero_grad(set_to_none=True)
        disc_loss = self._disc_loss(self.disc(hr_img), self.disc(sr.detach()))
        disc_loss.backward()
        self._average_gradients(self.disc)
        self.opt.disc.step()

        self.disc.requires_grad_(False)
        try:
            with torch.no_grad():
                feat_hr = self.vgg(hr_img)
            content = L.l1_loss(self.vgg(sr), feat_hr)
            gen_loss = self._gen_loss(sr, hr_img, content)
            self.opt.gen.zero_grad(set_to_none=True)
            gen_loss.backward()
        finally:
            self.disc.requires_grad_(True)
        self._average_gradients(self.gen)
        self.opt.gen.step()
        return torch.stack([disc_loss.detach(), gen_loss.detach()])

    def _batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the global batch (every rank's; the
        relativistic losses compare against it, as the JAX package's
        mean over its sharded batch does), differentiable."""
        if not (self.data_parallel and self.world_size > 1):
            return t.mean()
        return mesh.all_reduce_sum(t.sum()) / (t.numel() * self.world_size)

    def _average_gradients(self, module) -> None:
        """Under data parallelism, ``module``'s gradients averaged over
        the ranks (``mesh.allreduce_gradients``); the losses stay each
        rank's own."""
        if self.data_parallel:
            mesh.allreduce_gradients(module)

    def _set_gan_lrs(self, gen_lr: float, disc_lr: float) -> None:
        set_lr(self.opt.disc, disc_lr)
        set_lr(self.opt.gen, gen_lr)

    def pretrain_step(self, crops_u8: torch.Tensor,
                      flips: torch.Tensor) -> torch.Tensor:
        """One eager PSNR-phase step on a device batch; returns the
        loss."""
        loss = self._pretrain_body(crops_u8, flips)[0]
        self.step += 1
        return loss

    def gan_step(self, crops_u8: torch.Tensor, flips: torch.Tensor,
                 gen_lr: float, disc_lr: float) -> dict:
        """One eager adversarial step; returns the discriminator and
        generator losses."""
        self._set_gan_lrs(gen_lr, disc_lr)
        out = self._gan_body(crops_u8, flips)
        self.step += 1
        return {"disc_loss": out[0], "gen_loss": out[1]}

    def pretrain_step_multi(self, crops_k: torch.Tensor,
                            flips_k: torch.Tensor) -> torch.Tensor:
        """K PSNR-phase steps on a stacked (K, B, ...) device batch;
        returns the (K,) losses."""
        with trace.span("train.call", device=self.device, phase="psnr",
                        k=int(crops_k.shape[0])):
            return self._multi("psnr", self._pretrain_body, crops_k,
                               flips_k)[:, 0]

    def gan_step_multi(self, crops_k: torch.Tensor, flips_k: torch.Tensor,
                       gen_lr: float, disc_lr: float) -> dict:
        """K adversarial steps on a stacked device batch, at one pair of
        learning rates; returns the (K,) discriminator and generator
        losses."""
        with trace.span("train.call", device=self.device, phase="gan",
                        k=int(crops_k.shape[0])):
            self._set_gan_lrs(gen_lr, disc_lr)
            out = self._multi("gan", self._gan_body, crops_k, flips_k)
            return {"disc_loss": out[:, 0], "gen_loss": out[:, 1]}

    def _multi(self, phase: str, body, crops_k: torch.Tensor,
               flips_k: torch.Tensor) -> torch.Tensor:
        """K steps of ``body``, one stacked batch each; returns their
        (K, n) outputs and moves the step counter by K.  On the CPU, K
        eager steps.  On CUDA, replays of the
        phase's captured step: the first call for a (phase, batch shape,
        dtype) runs its first step eagerly on a side stream (the
        capture's warm-up) and captures the step after it."""
        k = crops_k.shape[0]
        if self.device.type != "cuda":
            out = torch.stack([body(c, f) for c, f in zip(crops_k, flips_k)])
            self.step += k
            return out
        key = (phase, tuple(crops_k.shape[1:]), self.compute_dtype)
        graph = self._graphs.get(key)
        outs = []
        if graph is None:
            with trace.span("train.capture"):
                outs.append(warm_up(body, crops_k[0], flips_k[0]))
                for opt in self.opt.all():
                    opt.zero_grad(set_to_none=True)
                graph = self._graphs[key] = StepGraph(
                    f"{self.model_name} {phase}", body, crops_k[0],
                    flips_k[0])
        for i in range(len(outs), k):
            outs.append(graph.replay(crops_k[i], flips_k[i]).clone())
        self.step += k
        return torch.stack(outs)

    def drop_graphs(self) -> None:
        """Forget the captured steps (after the state they read was
        replaced); the next multi-step call captures anew."""
        self._graphs.clear()

    @torch.no_grad()
    def eval_step(self, crops_u8: torch.Tensor, mask: torch.Tensor):
        """Masked batch PSNR (one log over the batch MSE), SSIM and
        pixel loss of the f32 generator on an eval batch."""
        lr_img, _bic, hr_img = synthesize_eval_triple(crops_u8, self.upscale)
        sr = self._generate(lr_img, False)
        mask = mask.float()
        denom = mask.sum().clamp_min(1.0)
        mse_b = (mse_per_sample(sr, hr_img) * mask).sum() / denom
        psnr_b = 10.0 * torch.log10(1.0 / mse_b.clamp_min(1e-12))
        ssim_b = (ssim_per_sample(sr, hr_img) * mask).sum() / denom
        per = torch.stack([self._pixel_loss(a, b) for a, b in zip(sr, hr_img)])
        loss_b = (per * mask).sum() / denom
        return psnr_b, ssim_b, loss_b

    # ------------------------------------------------------- utilities

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _load_sample_image(self) -> None:
        """The progress-sample image (``--sample-image``, else the
        reference's), where present (the render is skipped without
        it)."""
        self.sample_image = None
        path = getattr(self.args, "sample_image", None) or SAMPLE_IMAGE_PATH
        if not (self.save_image and self.main_process):
            return
        if os.path.exists(path):
            arr = image_io.load_image(path).astype(np.float32) / 255.0
            self.sample_image = torch.from_numpy(arr[None]).to(self.device)
        os.makedirs("output", exist_ok=True)

    def _full_state(self) -> dict:
        return {
            "disc_state": self.disc.state_dict(),
            **self.opt.state_dict(),
            "step": self.step,
            "best_psnr": float(self.best_psnr),
        }

    def _restore(self, checkpoint: dict, phase: str) -> int:
        """Install a checkpoint into the live state; returns its epoch.
        The rest of the training state is adopted only from a checkpoint
        of the same phase: the GAN phase starts from PSNR weights alone,
        with its own best-PSNR record."""
        self.gen.load_state_dict(checkpoint["state"])
        extra = checkpoint.get("extra")
        same_phase = str(checkpoint.get("phase", "")).split("-")[-1] == phase
        if extra and same_phase:
            if "disc_state" in extra:
                self.disc.load_state_dict(extra["disc_state"])
            # new moment tensors: a graph that read the old ones is stale
            self.opt.load_state_dict(extra)
            self.drop_graphs()
            self.step = int(extra.get("step", self.step))
            if "best_psnr" in extra:
                self.best_psnr = float(extra["best_psnr"])
        return int(checkpoint.get("epoch", 1))

    def _save(self, epoch: int, phase: str, kind: str) -> None:
        """Write ``{phase}-{kind}.pth`` (rank 0 only): enqueued to the
        writer thread, or in the loop under ``--sync-saves``."""
        if not self.main_process:
            return
        write = (save_checkpoint if self.ckpt_writer is None
                 else self.ckpt_writer.save)
        write(f"{phase}-{kind}.pth", epoch, phase, self.gen.state_dict(),
              extra=self._full_state())

    def _wait_saves(self, barrier: bool = False) -> None:
        """Drain the pending checkpoint writes (none under
        ``--sync-saves``): before a checkpoint file is read, at a
        phase's end, on preemption.  ``barrier``: then every rank meets
        (before a read: rank 0 alone writes)."""
        if self.ckpt_writer is not None:
            self.ckpt_writer.wait(log=self.logger.log)
        if barrier and self.data_parallel:
            torch.distributed.barrier()

    def _check_preemption(self, epoch: int, phase: str,
                          last: bool = False) -> None:
        """Between host calls: after a termination signal, write the full
        ``{phase}-latest.pth`` of the interrupted epoch (a resume re-runs
        it), wait for the file and raise ``TrainingPreempted``.  Under
        data parallelism every rank leaves after the same call: the
        ranks' flags are or'd (``mesh.RankVote``), read one call late,
        and ``last`` (after an epoch's final call) reads the vote still
        pending."""
        if self._preemption is None:
            return
        requested = self._preemption.requested
        if self._vote is not None:
            requested = (self._vote.drain() if last
                         else self._vote.cast(requested))
        if not requested:
            return
        self._sync()  # the replays in flight finish before the snapshot
        self._save(epoch, phase, "latest")
        self._wait_saves()
        self.logger.log(f"Preemption signal received: saved "
                        f"{phase}-latest.pth at epoch {epoch}; exiting "
                        f"cleanly")
        raise TrainingPreempted(phase)

    # ------------------------------------------------------------ eval

    def _test(self, epoch: int, phase: str, step: int) -> None:
        """Validation pass (PSNR/SSIM/val-loss), best/latest
        checkpoints, and the sample render."""
        self.logger.log(f"Testing results after epoch {epoch}")
        totals = torch.zeros(3, device=self.device)
        batches = total_valid = 0
        bs = self.test_loader.batch_size
        start_time = time.time()

        def host_iter():
            nonlocal total_valid
            for crops, valid in self.test_loader:
                total_valid += int(valid)
                yield crops, (np.arange(bs) < valid).astype(np.float32)

        for crops, mask in prefetch_to_device(host_iter(), self.device):
            totals += torch.stack(self.eval_step(crops, mask))
            batches += 1
        psnr_avg, ssim_avg, loss_avg = (totals / max(batches, 1)).tolist()
        throughput = total_valid / max(time.time() - start_time, 1e-9)
        self.logger.log(
            f"PSNR: {round(psnr_avg, 3)}, SSIM: {round(ssim_avg, 4)}, "
            f"Throughput: {round(throughput, 3)} images/sec"
        )
        short_phase = "".join(phase.split("-")[1:])
        self.logger.log_metrics({
            f"{short_phase}/PSNR": psnr_avg,
            f"{short_phase}/SSIM": ssim_avg,
            f"{short_phase}/val-loss": loss_avg,
            f"{short_phase}/throughput/test": throughput,
            f"{short_phase}/epoch": epoch,
        }, step=step)
        if psnr_avg > self.best_psnr:
            self.best_psnr = psnr_avg
            self._save(epoch, phase, "best")
        self._save(epoch, phase, "latest")
        self._render_sample(epoch)

    @torch.no_grad()
    def _render_sample(self, epoch: int) -> None:
        if self.sample_image is None:
            return
        sr = self._generate(self.sample_image, False)[0].cpu().numpy()
        image_io.save_image(sr, os.path.join("output", f"SR_epoch{epoch}.png"))
        if self.logger.logs_images:
            # a quarter-size copy, as the reference logs it
            from torchsr_tpu_torch.ops.resize import bicubic_resize

            quarter = bicubic_resize(
                torch.from_numpy(np.clip(sr, 0.0, 1.0)),
                (sr.shape[0] // 4, sr.shape[1] // 4), quantize=True)
            self.logger.log_image(f"images/epoch{epoch}",
                                  image_io.to_uint8(quarter.numpy()))

    # --------------------------------------------------------- phases

    def _stacked_epoch(self, shuffle_epoch: int, epoch_offset: int,
                       steps_per_call: int, run_call, metrics, *,
                       epoch: int = 1, phase: str = "") -> tuple[int, float]:
        """One epoch's steps, K a call (the JAX ``_stacked_epoch_loop``):
        ``run_call(crops_k, flips_k) -> (K,) losses`` gets full groups
        of ``steps_per_call`` batches and the ragged tail one batch a
        call; the preemption flag is read after each call (a preemption
        saves ``{phase}-latest.pth`` at ``epoch``).  Returns the
        reference's global sample-step of the last batch and the epoch's
        crops/s.  Per-step losses reach the host only when the logger
        consumes them, one transfer a call."""
        step = epoch_offset
        done = 0
        scale = self.batch_size * self.world_size
        start_time = time.time()
        for kind, (crops, flips) in prefetch_to_device_stacked(
            self.train_loader.epoch(shuffle_epoch), self.device,
            steps_per_call,
        ):
            if kind == "single":
                crops, flips = crops[None], flips[None]
            losses = run_call(crops, flips)
            k = len(crops)
            self.profiler.step(k)
            done += k
            self._check_preemption(epoch, phase)
            step = (done - 1) * scale + epoch_offset
            if self.logger.active:
                for j, lv in enumerate(losses.tolist()):
                    self.logger.log_metrics(
                        metrics(lv), step=(done - k + j) * scale + epoch_offset)
        self._check_preemption(epoch, phase, last=True)
        self._sync()
        throughput = done * scale / max(time.time() - start_time, 1e-9)
        self.logger.log(f"Throughput: {round(throughput, 3)} images/sec")
        return step, throughput

    def _pretrain(self) -> None:
        self.logger.log("=" * 80)
        self.logger.log("Starting pre-training")
        self._wait_saves(barrier=True)  # the resume reads files
        epoch = 1
        # an explicit --psnr-checkpoint replaces the default path
        path = find_checkpoint(
            self.psnr_checkpoint or f"{self.model_name}-psnr-latest.pth")
        checkpoint = load_checkpoint(path, self.model_name)
        if checkpoint:
            epoch = self._restore(checkpoint, "psnr")
            self.logger.log(f"Resuming pre-training from epoch {epoch}")
        for epoch in range(epoch, self.pre_epochs + 1):
            self.logger.log("-" * 80)
            self.logger.log(f"Starting epoch {epoch} out of {self.pre_epochs}")
            step, throughput = self._stacked_epoch(
                epoch - 1, (epoch - 1) * self.train_len,
                self.steps_per_call, self.pretrain_step_multi,
                lambda lv: {"psnr/train-loss": lv, "psnr/epoch": epoch},
                epoch=epoch, phase=f"{self.model_name}-psnr",
            )
            self.logger.log_metrics(
                {"psnr/throughput/train": throughput, "psnr/epoch": epoch},
                step=step)
            self._test(epoch, f"{self.model_name}-psnr", step)
        self._wait_saves(barrier=True)

    def _warn_if_random_vgg(self) -> None:
        if not self.vgg_pretrained:
            self.logger.log(RANDOM_VGG_WARNING)

    def _gan_train(self) -> None:
        self.logger.log("=" * 80)
        self.logger.log("Starting training loop")
        self._warn_if_random_vgg()
        self.drop_graphs()  # the pretrain step's graph is done with
        self._wait_saves(barrier=True)  # the resume branch reads files
        epoch = 1
        self.best_psnr = -1.0
        # explicit GAN checkpoint (exclusive) > gan-latest > psnr-latest
        path = find_checkpoint(
            self.gan_checkpoint or f"{self.model_name}-gan-latest.pth")
        checkpoint = load_checkpoint(path, self.model_name)
        if checkpoint:
            epoch = self._restore(checkpoint, "gan")
            self.logger.log(f"Resuming GAN training from epoch {epoch}")
        else:
            checkpoint = load_checkpoint(
                find_checkpoint(f"{self.model_name}-psnr-latest.pth"),
                self.model_name,
            )
            if checkpoint:
                self._restore(checkpoint, "gan")
                self.logger.log("Initialized GAN phase from PSNR weights")
        for epoch in range(epoch, self.epochs + 1):
            self.logger.log("-" * 80)
            self.logger.log(f"Starting epoch {epoch} out of {self.epochs}")
            gen_lr = step_lr_schedule(BASE_LR, epoch, self.epochs)
            disc_lr = step_lr_schedule(BASE_LR, epoch, self.epochs)

            def run_call(crops_k, flips_k):
                return self.gan_step_multi(crops_k, flips_k, gen_lr,
                                           disc_lr)["gen_loss"]

            step, throughput = self._stacked_epoch(
                self.pre_epochs + epoch - 1,
                (self.pre_epochs + epoch - 1) * self.train_len,
                self.gan_steps_per_call, run_call,
                lambda lv: {"gan/disc-lr": disc_lr, "gan/gen-lr": gen_lr,
                            "gan/train-loss": lv},
                epoch=epoch, phase=f"{self.model_name}-gan",
            )
            self.logger.log_metrics(
                {"gan/throughput/train": throughput, "gan/epoch": epoch},
                step=step)
            self._test(epoch, f"{self.model_name}-gan", step)
        self._wait_saves()

    def train(self) -> None:
        """Pretrain, then GAN-train; after a termination signal (unless
        ``--no-preempt-save``) return once ``-latest`` is written."""
        if self.preempt_save:
            self._preemption = PreemptionGuard().install()
        try:
            self._pretrain()
            self._gan_train()
        except TrainingPreempted:
            pass  # the checkpoint is on disk: exit cleanly
        finally:
            if self._preemption is not None:
                self._preemption.uninstall()
                self._preemption = None
            self.profiler.stop()
            self.logger.finish()
            if self.ckpt_writer is not None:
                self.ckpt_writer.close()  # raises a failed write


def discover_vgg_weights() -> str | None:
    """Pretrained VGG19 weights without an explicit flag:
    ``TORCHSR_VGG_WEIGHTS``, then ``~/.cache/torchsr_tpu/``, then
    torchvision's hub cache (``$TORCH_HOME/hub/checkpoints``)."""
    env = os.environ.get("TORCHSR_VGG_WEIGHTS")
    if env:
        if not os.path.exists(env):
            # as explicit as --vgg-weights: no silent random features
            raise FileNotFoundError(
                f"TORCHSR_VGG_WEIGHTS points at a missing file: {env}"
            )
        return env
    home = os.path.expanduser("~")
    torch_home = os.environ.get(
        "TORCH_HOME", os.path.join(home, ".cache", "torch"))
    for path in (
        os.path.join(home, ".cache", "torchsr_tpu", "vgg19.ckpt"),
        os.path.join(home, ".cache", "torchsr_tpu", "vgg19-dcbb9e9d.pth"),
        os.path.join(torch_home, "hub", "checkpoints", "vgg19-dcbb9e9d.pth"),
    ):
        if os.path.exists(path):
            return path
    return None


def _load_vgg_weights(path: str) -> dict:
    """A torchvision VGG19 state_dict from a ``.pth`` or from the JAX
    package's converted ``.ckpt``."""
    if path.endswith((".pth", ".pt")):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        return raw.get("state_dict", raw)
    from torchsr_tpu_torch.models.torch_compat import from_jax_variables
    from torchsr_tpu_torch.utils.checkpoint import _msgpack_restore

    with open(path, "rb") as fh:
        return from_jax_variables(_msgpack_restore(fh.read()))


class SRGANTrainer(GANTrainer):
    """SRGAN recipe: MSE pretrain; BCE GAN; VGG + 0.001 adv generator."""

    model_name = "srgan"

    def _build_models(self) -> None:
        self.gen = SRGANGenerator(
            num_residual=getattr(self.args, "num_residual", None) or 16,
            scale_factor=self.upscale, **self._seeded(0))
        self.disc = SRGANDiscriminator(image_size=self.crop_size,
                                       **self._seeded(1))
        self._build_vgg()

    def _pixel_loss(self, sr, hr):
        return L.mse_loss(sr, hr)

    def _disc_loss(self, real, fake):
        # BCE(D(hr), 1) + BCE(D(sr), 0) on probabilities
        return (L.bce_loss(real, torch.ones_like(real))
                + L.bce_loss(fake, torch.zeros_like(fake)))

    def _gen_loss(self, sr, hr, content):
        # content + 0.001 BCE(D(sr), 1): one discriminator call, on sr
        fake = self.disc(sr)
        return content + 0.001 * L.bce_loss(fake, torch.ones_like(fake))


class ESRGANTrainer(GANTrainer):
    """ESRGAN recipe: L1 pretrain; relativistic-average GAN."""

    model_name = "esrgan"
    GAN_STEPS_PER_CALL = 2

    def _build_models(self) -> None:
        self.gen = ESRGANGenerator(
            num_rrdb_blocks=getattr(self.args, "num_residual", None) or 23,
            scale_factor=self.upscale, **self._seeded(0))
        self.disc = ESRGANDiscriminator(image_size=self.crop_size,
                                        **self._seeded(1))
        self._build_vgg()

    def _pixel_loss(self, sr, hr):
        return L.l1_loss(sr, hr)

    def _disc_loss(self, real, fake):
        # [BCEwL(D(hr) - mean D(sr), 1) + BCEwL(D(sr) - mean D(hr), 0)] / 2
        loss_real = L.bce_with_logits_loss(real - self._batch_mean(fake),
                                           torch.ones_like(real))
        loss_fake = L.bce_with_logits_loss(fake - self._batch_mean(real),
                                           torch.zeros_like(fake))
        return (loss_real + loss_fake) / 2.0

    def _gen_loss(self, sr, hr, content):
        # 0.01 L1 + content + 0.005 BCEwL(D(sr) - mean D(hr), 1); D(hr)
        # carries no gradient (hr is data), but updates the statistics
        with torch.no_grad():
            real = self.disc(hr)
        fake = self.disc(sr)
        adv = L.bce_with_logits_loss(fake - self._batch_mean(real),
                                     torch.ones_like(fake))
        return 0.01 * L.l1_loss(sr, hr) + content + 0.005 * adv


def run_train(args: Namespace) -> GANTrainer:
    """The ``train`` subcommand: datasets from ``--train-dir`` (and
    ``--eval-dir``), the model's trainer on ``--device``, both phases;
    under torchrun (or Slurm) one data-parallel rank a process, on
    ``cuda:{LOCAL_RANK}`` with NCCL (gloo under ``--device cpu``)."""
    import random

    from torchsr_tpu_torch.data.loader import initialize_datasets
    from torchsr_tpu_torch.infer.runner import resolve_device
    from torchsr_tpu_torch.registry import select_trainer_model

    device = resolve_device(getattr(args, "device", "cuda"))
    ctx = mesh.detect_distributed(getattr(args, "master_addr", None),
                                  getattr(args, "master_port", None),
                                  device=device)
    mesh.check_num_devices(ctx, getattr(args, "num_devices", None))
    device = mesh.rank_device(ctx, device)
    if getattr(args, "seed", 0):
        random.seed(args.seed)
        np.random.seed(args.seed)
    trainer_cls, crop_size = select_trainer_model(args)
    loaders = initialize_datasets(
        args.train_dir, batch_size=args.batch_size,
        crop_size=getattr(args, "crop_size", None) or crop_size,
        dataset_multiplier=getattr(args, "dataset_multiplier", 1),
        workers=getattr(args, "data_workers", 16),
        seed=args.seed, eval_directory=getattr(args, "eval_dir", None),
        shuffle_window=getattr(args, "shuffle_window", 0),
        num_shards=ctx.world_size, shard_index=max(ctx.rank, 0),
    )
    trainer = trainer_cls(args, *loaders, device=device, dist_ctx=ctx)
    trainer.train()
    return trainer
