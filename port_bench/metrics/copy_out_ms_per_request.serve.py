"""The frame's copy to the host, per request: the mean device time of
the port's ``serve.copy_out`` span (``torchsr_tpu_torch/utils/trace.py``:
CUDA events on the service's stream around ``infer/server.py``
``CheckpointUpscaleService._upscale``'s ``u8.cpu()``, the uint8 x4
frame into pageable host memory).  The port records its spans only
while a profiler records, so these are the traced slice's requests,
every try counted; a port without the spans, or a ring that let
records go, gives nothing.  Layer: the service.  Moves:
serve_output_mp_per_s."""

UNIT = "ms"
LAYER = "service"
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
    times = [s.device_ms for s in spans(ctx, "serve.copy_out")
             if s.device_ms is not None]
    if not times:
        return None
    return sum(times) / len(times)
