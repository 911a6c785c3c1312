"""A training step captured into a CUDA graph, replayed once a batch.

The counterpart of the JAX trainer's multi-step programs
(``torchsr_tpu/train/trainer.py`` :475-541), which run K steps per host
call as a ``lax.scan`` over a stacked batch axis to amortize per-call
dispatch.  Here the step is captured once into a ``torch.cuda.CUDAGraph``
(as ``scan`` traces its body once) and replayed K times a call: before
each replay the batch is copied into the graph's static input on the
device, after it the graph's static outputs are copied out.  A replay
issues the step's thousands of kernels from one host call.

Everything a graph reads must outlive its capture at a fixed address:
the static inputs, the parameters and buffers (updated in place), the
optimizers' moments, step counts and learning-rate tensors
(``train/state.py``), and what the step allocates, which comes from the
graph's private memory pool.  Whoever replaces any of them (loading a
checkpoint into the optimizers) drops the graph and captures anew.

The launch counters of ``ops/rdb.py`` advance in Python, at capture and
not at replay: ``StepGraph`` records what a capture added, takes it back
(a capture runs nothing), and adds it once per replay, so that every
counter still states launches that ran.
"""

from __future__ import annotations

import torch

from torchsr_tpu_torch.ops import rdb as rdb_ops


def launch_counts() -> dict:
    """The RDB kernels' launch counters, by name."""
    return {name: getattr(rdb_ops, name) for name in rdb_ops.LAUNCH_COUNTERS}


def add_launch_counts(delta: dict, times: int = 1) -> None:
    for name, n in delta.items():
        setattr(rdb_ops, name, getattr(rdb_ops, name) + n * times)


def warm_up(body, *inputs) -> torch.Tensor:
    """Run ``body(*inputs)`` eagerly on a side stream, as a capture
    wants before it: the step's lazy state (optimizer moments, library
    handles and workspaces) is made outside any graph's pool.  It is a
    real step; its output is returned on the current stream."""
    main = torch.cuda.current_stream(inputs[0].device)
    side = torch.cuda.Stream(inputs[0].device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = body(*inputs)
    main.wait_stream(side)
    return out


class StepGraph:
    """``body(crops, flips) -> outputs`` captured once; ``replay`` runs
    it on a new batch.  The caller has warmed the step up and set every
    gradient it makes to None, so that the captured backward allocates
    them in the graph's pool."""

    def __init__(self, name: str, body, crops: torch.Tensor,
                 flips: torch.Tensor) -> None:
        self.name = name
        self.crops = crops.clone()
        self.flips = flips.clone()
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        try:
            with torch.cuda.graph(self.graph):
                self.out = body(self.crops, self.flips)
        except RuntimeError as exc:
            raise RuntimeError(
                f"capturing the {name} step into a CUDA graph failed: {exc}"
            ) from exc
        finally:
            after = launch_counts()
            add_launch_counts({k: before[k] - after[k] for k in before})
        self.launches = {k: after[k] - before[k] for k in before}

    def replay(self, crops: torch.Tensor,
               flips: torch.Tensor) -> torch.Tensor:
        """One step on (crops, flips); returns the graph's static output
        (overwritten by the next replay)."""
        self.crops.copy_(crops)
        self.flips.copy_(flips)
        self.graph.replay()
        add_launch_counts(self.launches)
        return self.out
