"""Distributed environment detection and the data-parallel plumbing.

The port of ``torchsr_tpu/parallel/mesh.py``.  The launcher surface is
the JAX package's (and the reference's): torchrun's ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, else Slurm's
``SLURM_NTASKS``, ``SLURM_PROCID``, ``SLURM_LOCALID`` and
``SLURM_NTASKS_PER_NODE``; without either, world 1 and rank -1.  Where
the JAX package hands that to ``jax.distributed.initialize``, the port
starts a ``torch.distributed`` process group: NCCL on CUDA (after
``torch.cuda.set_device(local_rank)``), gloo only when the run asks for
the CPU.  ``--master-addr`` / ``--master-port`` override
``MASTER_ADDR`` / ``MASTER_PORT``.

The data-parallel model is the JAX package's: parameters and optimizer
state replicated (every rank builds them from one seed; rank 0's are
broadcast once), each rank trains on its shard of every epoch
(``data/loader.py`` ``num_shards`` / ``shard_index``), the gradients
are averaged over ranks inside the step (``allreduce_gradients``: one
all-reduce of the flattened gradients, which a CUDA graph captures),
and BatchNorm statistics span the global batch
(``models/layers.py`` ``BatchNorm.sync_group``).
"""

from __future__ import annotations

import copy
import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DistributedContext:
    """Resolved multi-process parameters (the reference's
    ``distributed_params``)."""

    world_size: int
    rank: int
    local_rank: int
    local_world_size: int
    distributed: bool

    @property
    def main_process(self) -> bool:
        # rank -1 without a launcher, the reference's convention
        return self.rank in (-1, 0)


SINGLE = DistributedContext(1, -1, -1, 1, False)


def _env_context(env) -> DistributedContext:
    """torchrun's variables, then Slurm's (which set ``RANK`` and
    ``WORLD_SIZE`` for what reads them later), else a single process."""
    try:
        return DistributedContext(
            int(env["WORLD_SIZE"]), int(env["RANK"]),
            int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"]), True)
    except (KeyError, ValueError):
        pass
    try:
        ctx = DistributedContext(
            int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"]),
            int(env["SLURM_LOCALID"]), int(env["SLURM_NTASKS_PER_NODE"]),
            True)
    except (KeyError, ValueError):
        return SINGLE
    env["RANK"] = str(ctx.rank)
    env["WORLD_SIZE"] = str(ctx.world_size)
    return ctx


def detect_distributed(master_addr: str | None = None,
                       master_port: str | int | None = None, *,
                       device: str | torch.device = "cuda",
                       env=None) -> DistributedContext:
    """The launcher's context; under a launcher, the default process
    group is started (once): NCCL on a CUDA ``device`` (the process
    takes ``cuda:{local_rank}``), gloo on the CPU.  A CUDA run never
    falls back to gloo."""
    env = os.environ if env is None else env
    ctx = _env_context(env)
    if not ctx.distributed or dist.is_initialized():
        return ctx
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a distributed CUDA run needs CUDA; pass --device cpu for "
                "a gloo process group on the CPU")
        torch.cuda.set_device(ctx.local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    addr = master_addr or env.get("MASTER_ADDR", "127.0.0.1")
    port = master_port or env.get("MASTER_PORT", "29500")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=ctx.world_size, rank=ctx.rank)
    return ctx


def rank_device(ctx: DistributedContext,
                device: str | torch.device) -> torch.device:
    """A rank's device: ``cuda:{local_rank}`` for a distributed CUDA
    run, else ``device`` as given."""
    device = torch.device(device)
    if ctx.distributed and device.type == "cuda":
        return torch.device("cuda", ctx.local_rank)
    return device


def check_num_devices(ctx: DistributedContext,
                      num_devices: int | None) -> None:
    """``--num-devices`` bounds the devices a training run uses (the JAX
    package's mesh size); a launcher world that disagrees raises."""
    if num_devices and ctx.world_size != num_devices:
        raise ValueError(
            f"--num-devices {num_devices} but the launcher started "
            f"{ctx.world_size} process(es), one device each: launch "
            f"torchrun --nproc-per-node {num_devices} or drop the flag")


def local_devices(device: str | torch.device = "cuda") -> list:
    """Every visible device of ``device``'s kind, as the JAX package
    takes ``jax.devices()``: each CUDA card, or the one CPU."""
    if torch.device(device).type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def replicate_module(module: torch.nn.Module, devices: list) -> list:
    """One copy of ``module`` per entry of ``devices`` (a device listed
    twice gets two copies), each on its device."""
    return [copy.deepcopy(module).to(d) for d in devices]


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every rank's parameters and buffers to rank ``src``'s."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)


def allreduce_gradients(module: torch.nn.Module) -> None:
    """Average the gradients of ``module`` over the ranks: one
    all-reduce of their concatenation (a parameter without one joins as
    zeros, so every rank sends the same layout), divided by the world
    size, copied back into each ``.grad``.  Device work only: a CUDA
    graph captures it."""
    params = [p for p in module.parameters() if p.requires_grad]
    if not params:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    offset = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, differentiable: the backward sums the
    ranks' gradients the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (the default group:
    None), differentiable."""
    return _AllReduceSum.apply(x, group)


class RankVote:
    """A flag or'd over the ranks once per host call, read one call
    late so that the host never waits for the device it has just fed.

    ``cast(flag)`` enqueues this call's all-reduce (a fill, the
    all-reduce and a copy into pinned host memory behind an event: no
    host wait) and returns the previous call's result, waiting only for
    that call's work, while this call's is already queued.  ``drain()``
    returns the last result cast and clears it.  Every rank casts at
    the same calls, so every rank reads the same result at the same
    call."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self._pending = None

    def cast(self, flag: bool) -> bool:
        t = torch.full((1,), float(flag), device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        done = None
        if self.device.type == "cuda":
            host = torch.empty(1, pin_memory=True)
            host.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            t = host
        previous, self._pending = self._pending, (t, done)
        return self._read(previous)

    def drain(self) -> bool:
        previous, self._pending = self._pending, None
        return self._read(previous)

    @staticmethod
    def _read(vote) -> bool:
        if vote is None:
            return False
        value, done = vote
        if done is not None:
            done.synchronize()
        return bool(value[0])
