"""Data-parallel training cells: the port's trainer on every card of the
cell, one process a card, NCCL between them.

Rank 0 runs in the harness's process on ``cuda:0``; ranks 1 .. world - 1
are processes this module spawns (``python -m port_bench.drivers.train_ddp
--rank r ...``) on ``cuda:r``, with torchrun's variables and a free local
port, and, as torchrun sets for a run of several processes, one OpenMP
thread a process (``OMP_NUM_THREADS=1``; rank 0 ``torch.set_num_threads
(1)``): four processes of one intra-op thread a core each would
oversubscribe the host, whose threads launch the replays and drive
NCCL.  Every rank starts its process group with a timeout
(``TIMEOUT_S``), NCCL for the step and gloo for this module's own host
messages, then builds the model's trainer through the port's
data-parallel path (``parallel/mesh.py`` ``detect_distributed``: the
parameters broadcast from rank 0, BatchNorm statistics over the global
batch, the gradients all-reduced inside the captured step), copies the
benchmark's seeded weights into it, and feeds its own prefetcher from
its own rows of the seeded crops: the traffic's ``batch`` rows a rank,
rank r's rows of global batch j made by ``RankCrops`` from their own
generator (seed, r, j), as ``generate.Crops`` makes a crop, so that a
rank makes only its own epoch in set-up and rank 0 makes the three
global batches that the reference reads.

All ranks run the same calls, in the same order, as the single-card
module (``drivers/train.py``) does: step 1 alone (the capture's
warm-up), steps 2-3, one K-step call; then ``TIMED`` calls whose time on
rank 0 fixes the number of calls in the window (``--seconds`` over the
time a call, rounded up, sent to every rank), so that no host vote runs
inside the window.  The window starts after a barrier and ends on rank
0's readback; ``train_crops_per_s`` is the global crops (world x batch x
steps) over rank 0's window.  The traced slice (``--trace 1``) profiles
rank 0's calls after the window; before each try rank 0 tells the other
ranks, by a gloo broadcast, to run the same calls (and after the last,
to stop).

The check: each step's losses are every rank's own (the port keeps a
rank's loss its own, with the relativistic means over the global
batch), averaged over the ranks, and rank 0's first gradients and
changes (averaged gradients: the same on every rank), against
``reference/ddp.py``: the reference step on all world x batch rows, f32
with TF32 off, on rank 0's card once every trainer is freed and the
other ranks have left.

A worker that fails makes rank 0 fail: a thread watches the workers and
ends the process (non-zero) when one exits with an error; every worker is
killed and joined on any exit of rank 0, and the process groups' timeout
bounds a collective that waits on a rank that is gone.
"""

from __future__ import annotations

import argparse
import atexit
import datetime
import gc
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
from argparse import Namespace

import numpy as np
import torch

from port_bench import compare, generate, harness, trace, weights
from port_bench.drivers.train import (
    QuietLogger,
    changes,
    first_gradients,
    model_weights,
)
from port_bench.reference import ddp, ops

TIMEOUT_S = 300
TIMED = 3
JOIN_S = 60


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank: int, world: int, port: int) -> dict:
    return {"WORLD_SIZE": str(world), "RANK": str(rank),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


class Workers:
    """Ranks 1 .. world - 1 as child processes, watched: one that exits
    non-zero before ``done()`` ends this process with status 1."""

    def __init__(self, r, world: int, port: int):
        self.procs = []
        self._done = threading.Event()
        for rank in range(1, world):
            env = {"OMP_NUM_THREADS": "1", **os.environ,
                   **_env(rank, world, port)}
            cmd = [sys.executable, "-m", "port_bench.drivers.train_ddp",
                   "--rank", str(rank), "--workload", r.name, "--seed",
                   str(r.seed), "--seconds", str(r.seconds), "--trace",
                   str(int(r.trace)), "--device", r.device.type,
                   "--overrides", json.dumps(r.hooks.get("overrides", {}))]
            self.procs.append(subprocess.Popen(
                cmd, cwd=harness.CHECKOUT, env=env, stdout=sys.stderr,
                stderr=sys.stderr, stdin=subprocess.DEVNULL))
        atexit.register(self.kill)
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self._done.is_set():
            for p in self.procs:
                rc = p.poll()
                if rc not in (None, 0) and not self._done.is_set():
                    harness.log(f"train_ddp: a worker exited with {rc}; "
                                f"ending the run")
                    self.kill()
                    os._exit(1)
            time.sleep(0.5)

    def done(self) -> None:
        """The workers may leave now: wait for them, then stop watching."""
        deadline = time.monotonic() + JOIN_S
        for p in self.procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        self._done.set()
        bad = [p.returncode for p in self.procs if p.returncode != 0]
        self.kill()
        if bad:
            raise RuntimeError(f"train_ddp: workers ended with {bad}")

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass


def _groups(rank: int, world: int, device):
    """The default group (NCCL on the cards, gloo for a rehearsal on the
    CPU; with the timeout) and a gloo group for host messages; the
    port's context from its own detection."""
    import torch.distributed as dist

    from torchsr_tpu_torch.parallel import mesh

    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    env = _env(rank, world, int(os.environ["MASTER_PORT"]))
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{env['MASTER_PORT']}",
        world_size=world, rank=rank, timeout=timeout)
    ctx = mesh.detect_distributed(device=device.type, env=env)
    host = dist.new_group(backend="gloo", timeout=timeout)
    return ctx, host


def _tell(value: int, host) -> int:
    """Rank 0's ``value`` on every rank (a gloo broadcast)."""
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64)
    dist.broadcast(t, 0, group=host)
    return int(t[0])


def build_trainer(r, mix: dict, w: dict, ctx):
    """``drivers/train.py``'s trainer, built with the process group's
    context (the port's data-parallel path)."""
    from torchsr_tpu_torch.train.trainer import ESRGANTrainer, SRGANTrainer

    cfg = r.config
    args = Namespace(
        batch_size=mix["batch"], disable_amp=False, epochs=1,
        pretrain_epochs=1, gan_checkpoint=None, psnr_checkpoint=None,
        seed=0, skip_image_save=True, model=cfg["family"],
        num_residual=cfg.get("num_rrdb", cfg.get("num_residual")),
        vgg_convs=cfg.get("vgg_convs"), metrics_file=None, vgg_weights=None,
        steps_per_call=mix.get("steps_per_call", 0), no_preempt_save=True,
        sync_saves=True, upscale_factor=cfg["scale"])
    loader = generate.Loader(mix["batch"], mix["crop"],
                             mix["batches_per_epoch"])
    cls = {"esrgan": ESRGANTrainer, "srgan": SRGANTrainer}[cfg["family"]]
    trainer = cls(args, loader, loader, loader.dataset_len,
                  loader.dataset_len, device=r.device, logger=QuietLogger(),
                  dist_ctx=ctx)
    weights.load_into(trainer.gen, w["g"])
    weights.load_into(trainer.disc, w["d"])
    weights.load_into(trainer.vgg, w["v"])
    return trainer


def rank_rows(mix: dict, seed: int, rank: int, j: int) -> tuple:
    """Rank ``rank``'s ``batch`` rows of global batch ``j`` of a
    ``crops`` mix: uniform noise through each crop's own brightness and
    contrast, as ``generate.Crops`` makes them, from the generator
    (seed, 6, rank, j)."""
    b, s = mix["batch"], mix["crop"]
    rng = np.random.default_rng([int(seed) % (1 << 64), 6, rank, j])
    crops = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    flips = rng.random((b, 2)) < 0.5
    mean = rng.uniform(*mix["mean"], (b, 1))
    contrast = rng.uniform(*mix["contrast"], (b, 1))
    levels = np.arange(256) / 255.0 - 0.5
    lut = np.clip(np.rint(255.0 * (mean + contrast * levels)), 0, 255)
    rows = np.arange(b)[:, None, None, None]
    return lut.astype(np.uint8)[rows, crops], flips


def global_batch(mix: dict, seed: int, world: int, j: int) -> tuple:
    """Global batch ``j``: every rank's rows, rank 0's first."""
    parts = [rank_rows(mix, seed, r, j) for r in range(world)]
    return tuple(np.concatenate(a) for a in zip(*parts))


class RankCrops(generate.Crops):
    """A rank's epoch of a data-parallel ``crops`` mix (``rank_rows`` of
    each of its ``batches_per_epoch`` batches), epochs back to back."""

    def __init__(self, mix: dict, seed: int, rank: int):
        self.mix = mix
        made = [rank_rows(mix, seed, rank, j)
                for j in range(mix["batches_per_epoch"])]
        self.crops = np.stack([c for c, _ in made])
        self.flips = np.stack([f for _, f in made])


def _steps(r, rank: int, world: int) -> dict:
    """Every rank's part of a run (module docstring); rank 0's readings
    in the returned dict."""
    import torch.distributed as dist

    from torchsr_tpu_torch.data.prefetch import prefetch_to_device_stacked

    cfg, mix, dev = r.config, r.traffic, r.device
    ctx, host = _groups(rank, world, dev)
    log = harness.log if rank == 0 else (lambda _m: None)
    data = RankCrops(mix, r.seed, rank)
    log(f"setup: crops made at {time.perf_counter() - r.t_start:.3f} s")
    w = model_weights(cfg, mix, r.seed, dev, cfg.get("vgg_convs"))
    trainer = build_trainer(r, mix, w, ctx)
    log(f"setup: {world} trainers built at "
        f"{time.perf_counter() - r.t_start:.3f} s")
    lr = mix["lr"]
    k = trainer.gan_steps_per_call
    spans = trace.Spans()

    def call(item: tuple) -> torch.Tensor:
        kind, (crops, flips) = item
        if kind == "single":
            crops, flips = crops[None], flips[None]
        with spans("step.call"):
            out = trainer.gan_step_multi(crops, flips, lr, lr)
            return torch.stack([out["disc_loss"], out["gen_loss"]], 1)

    def feed(start: int, stop=None, group: int = k, stop_event=None):
        return prefetch_to_device_stacked(
            data.stream(start, stop, stop_event), dev, group)

    first = [call(item) for item in feed(0, 1, 1)]          # step 1
    grad1 = first_gradients(trainer, "gan")
    second = [call(item) for item in feed(1, 3, 2)]         # steps 2-3
    change = changes(trainer, "gan", w)
    early = torch.cat(first + second)
    dist.all_reduce(early)                                  # ranks' mean
    early = (early / world).cpu().tolist()
    log(f"setup: steps 1-3 done at {time.perf_counter() - r.t_start:.3f} s")
    stop = threading.Event()
    stream = feed(3, stop_event=stop)
    float(call(next(stream))[-1, -1])                       # one K-step call
    t0 = time.perf_counter()
    for _ in range(TIMED):
        last = call(next(stream))
    float(last[-1, -1])
    per_call = (time.perf_counter() - t0) / TIMED
    n_calls = _tell(max(1, math.ceil(r.seconds / per_call)), host)
    log(f"setup: {TIMED} timed calls, {per_call * 1e3:.3f} ms a call: "
        f"{n_calls} calls in the window")

    dist.barrier(group=host)
    t_window = time.perf_counter()
    setup_s = t_window - r.t_start
    waits, outs = [], []
    for _ in range(n_calls):
        t0 = time.perf_counter()
        with spans("prefetch.next"):
            item = next(stream)
        waits.append(time.perf_counter() - t0)
        outs.append(call(item))
    losses = torch.cat(outs).cpu().numpy()                  # the readback
    window_s = time.perf_counter() - t_window
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    def run_slice():
        _tell(1, host)
        last = None
        for _ in range(r.cell["slice"]["calls"]):
            with spans("prefetch.next"):
                item = next(stream)
            last = call(item)
        with spans("readback"):
            float(last[-1, -1])

    sliced = None
    if r.trace:
        if rank == 0:
            calls = r.cell["slice"]["calls"]
            sliced = trace.profile(
                run_slice, units=calls * k,
                families=r.cell["slice"]["families"], calls=calls,
                spans=spans, device=dev)
            _tell(0, host)
        else:
            while _tell(0, host):
                for _ in range(r.cell["slice"]["calls"]):
                    last = call(next(stream))
                float(last[-1, -1])
    stop.set()
    for _ in stream:  # the producer ends; its thread is joined
        pass
    dist.barrier(group=host)
    del trainer, stream, outs, first, second
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return {"w": w, "early": early, "grad1": grad1,
            "change": change, "losses": losses, "waits": waits,
            "window_s": window_s, "setup_s": setup_s, "k": k,
            "memory_peak": memory_peak, "sliced": sliced,
            "n_calls": n_calls}


def run(r: "harness.Run") -> "harness.Outcome":
    world = int(r.cell.get("chips", 1))
    cfg, mix, dev = r.config, r.traffic, r.device
    if cfg["family"] != "esrgan" or mix["phase"] != "gan":
        raise ValueError("train_ddp runs ESRGAN's GAN phase")
    port = _free_port()
    os.environ.update(_env(0, world, port))
    threads = torch.get_num_threads()
    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", 1)))
    workers = Workers(r, world, port)
    try:
        got = _steps(r, 0, world)
        workers.done()
    finally:
        workers.kill()
        torch.set_num_threads(threads)
    losses, steps = got["losses"], len(got["losses"])
    failed = int((~np.isfinite(losses)).any(axis=1).sum())
    rows = mix["batch"] * world
    notes = [f"train_ddp: {world} ranks, {got['n_calls']} calls, {steps} "
             f"steps of {rows} in {got['window_s']:.3f} s, {failed} "
             f"with a non-finite loss; set-up {got['setup_s']:.3f} s; peak "
             f"{got['memory_peak']} bytes on cuda:0"]
    t_ref = time.perf_counter()
    batches = [tuple(torch.from_numpy(a).to(dev)
                     for a in global_batch(mix, r.seed, world, j))
               for j in range(3)]
    with ops.exact_f32():
        ref = ddp.run_steps(cfg, got["w"], batches, lr=mix["lr"],
                            chunk=mix["batch"],
                            vgg_convs=cfg.get("vgg_convs"))
    mine = {"losses": got["early"], "grad1": got["grad1"],
            "change": got["change"]}
    values = compare.training(mine, ref)
    notes.append(f"train_ddp: reference of 3 steps on {rows} rows "
                 f"in {time.perf_counter() - t_ref:.3f} s; leaves left "
                 f"out of the norm gaps: {compare.excluded(ref)}")
    notes.append(f"train_ddp: losses of steps 1-3, ranks' mean "
                 f"{got['early']}, reference {ref['losses']}")
    notes.append(f"train_ddp: worst leaves {compare.worst_leaves(mine, ref)}")
    notes.append(f"train_ddp: numbers {values}")
    checks = harness.checks_from(values, r.cell["check"]["limits"])
    window = {"seconds": got["window_s"], "steps": steps,
              "batch": mix["batch"], "crop": mix["crop"], "phase": "gan",
              "input_wait_s": got["waits"]}
    return harness.Outcome(
        setup_s=got["setup_s"],
        end_to_end={"train_crops_per_s": (steps * rows
                                          / got["window_s"], "crops/s"),
                    "device_peak_gib": (got["memory_peak"] / 2 ** 30,
                                        "GiB")},
        window=window, checks=checks, attempted=steps, failed=failed,
        memory_peak_bytes=got["memory_peak"], slice=got["sliced"],
        notes=notes)


def worker(argv=None) -> int:
    """Rank ``--rank``'s process (spawned by ``run``)."""
    p = argparse.ArgumentParser(description="a rank of a train_ddp cell")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--overrides", default="{}")
    args = p.parse_args(argv)
    harness.set_environment()
    device = (torch.device("cuda", args.rank) if args.device == "cuda"
              else torch.device(args.device))
    r = harness.Run.of(args.workload, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device=device,
                       t_start=time.perf_counter(),
                       hooks={"overrides": json.loads(args.overrides)})
    _steps(r, args.rank, int(r.cell.get("chips", 1)))
    return 0


if __name__ == "__main__":
    sys.exit(worker())
