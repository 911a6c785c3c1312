"""Host time blocked in the prefetcher's ``next()`` (the harness's
``prefetch.next`` span around ``data/prefetch.py``
``prefetch_to_device_stacked``), per K-step call, mean over the
``--trace 1`` run's measured window.  Layer: the input
(``data/prefetch.py``).  Moves: train_crops_per_s."""

UNIT = "ms"
LAYER = "input"
MOVES = "train_crops_per_s"


def read(ctx):
    waits = ctx["window"].get("input_wait_s")
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
