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

The launch counters of the model kernels (``ops.MODEL_KERNELS``:
``ops/rdb.py`` and ``ops/bn_act.py``) advance in Python, at capture and
not at replay: ``StepGraph`` records what a capture added, takes it back
(a capture runs nothing), and adds it once per replay, so that every
counter still states launches that ran.  The
process counters ``graph_captures`` and ``graph_replays``
(``utils/trace.py``) count the captures and replays themselves, of
these steps and of the tile forwards; a capture in steady state is a
graph built again.  A replay
is the span ``train.replay``, timed on the device: nothing inside a
replayed graph can carry a host span.
"""

from __future__ import annotations

import contextlib
import gc

import torch

from torchsr_tpu_torch.ops import add_launch_counts, launch_counts
from torchsr_tpu_torch.utils import trace


@contextlib.contextmanager
def gc_paused():
    """Collect Python's dead cycles, then keep the cyclic collector off
    for the block (a capture): a collection inside a capture can free an
    older CUDA graph held by a dead cycle, whose reset is not permitted
    while a stream captures, and the capture fails ("operation failed
    due to a previous error during capture").  ``torch.cuda.graph`` no
    longer collects before it begins unless asked to."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


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
            with trace.span("graph.capture"), gc_paused(), \
                    torch.cuda.graph(self.graph):
                self.out = body(self.crops, self.flips)
        except RuntimeError as exc:
            raise RuntimeError(
                f"capturing the {name} step into a CUDA graph failed: {exc}"
            ) from exc
        finally:
            after = launch_counts()
            add_launch_counts({k: before[k] - after[k] for k in before})
        trace.count("graph_captures")
        self.launches = {k: after[k] - before[k] for k in before}

    def replay(self, crops: torch.Tensor,
               flips: torch.Tensor) -> torch.Tensor:
        """One step on (crops, flips); returns the graph's static output
        (overwritten by the next replay)."""
        self.crops.copy_(crops)
        self.flips.copy_(flips)
        with trace.span("train.replay", device=self.crops.device):
            self.graph.replay()
        add_launch_counts(self.launches)
        trace.count("graph_replays")
        return self.out
