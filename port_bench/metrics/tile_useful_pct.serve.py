"""The tiler's useful share of the LR pixels its tile batches compute:
100 x every frame's LR pixels over the pixels of every tile slot run
for it (slots x tile^2: the overlap and the last batch's padding
counted), summed over the port's ``tiled.cut`` spans
(``torchsr_tpu_torch/utils/trace.py``; attrs ``lr_px`` and ``slot_px``).
The port records its spans only while a profiler records, so these are
the traced slice's requests, every try counted; a port without the
spans, or a ring that let records go, gives nothing.  Layer: the
tiler (``infer/tiled.py`` ``cut_tiles``).  Moves:
serve_output_mp_per_s."""

UNIT = "%"
LAYER = "tiler"
MOVES = "serve_output_mp_per_s"


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
    cuts = spans(ctx, "tiled.cut")
    slot_px = sum(s.attrs["slot_px"] for s in cuts)
    if not slot_px:
        return None
    return 100.0 * sum(s.attrs["lr_px"] for s in cuts) / slot_px
