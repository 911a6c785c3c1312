"""The stream's time in a K-step training call outside its replayed
graphs, per call: the mean over the port's ``train.call`` spans of
their device time less the device time of their ``train.replay``
children (``torchsr_tpu_torch/utils/trace.py``: CUDA events on the
trainer's stream, ``train.call`` from the entry of ``*_step_multi`` to
its return, ``train.replay`` around each ``graph.replay()``).  What is
left is the static-input copies, the output clones and stack, the
learning-rate writes and the device's idle time between them.  The
port records its spans only while a profiler records, so these are the
traced slice's calls, every try counted; a port without the spans,
or a ring that let records go, gives nothing.  It reads 0.1-0.35 ms of
a ~140-ms call on the H100, with a spread as large as the value, so
it shows a change of that time above ~0.2 ms a call; the
kernel-to-kernel gaps inside the graphs, where most of a call's idle
lies, are not in it.  Layer: the model step (``train/trainer.py``
``_multi``, ``train/graphs.py``).  Moves: train_crops_per_s."""

UNIT = "ms"
LAYER = "model step"
MOVES = "train_crops_per_s"


def spans(ctx, name: str) -> list:
    if not ctx["slice"]:
        return []
    try:
        from torchsr_tpu_torch.utils import trace
    except ImportError:  # a port that records no spans
        return []
    if trace.dropped():  # the full ring let records go: roots lack parts
        return []
    return trace.records(name)


def read(ctx):
    replayed: dict = {}
    for s in spans(ctx, "train.replay"):
        if s.device_ms is not None:
            replayed[s.parent] = replayed.get(s.parent, 0.0) + s.device_ms
    gaps = [c.device_ms - replayed.get(c.id, 0.0)
            for c in spans(ctx, "train.call") if c.device_ms is not None]
    if not gaps:
        return None
    return sum(gaps) / len(gaps)
