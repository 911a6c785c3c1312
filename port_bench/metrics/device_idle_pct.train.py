"""The device's idle share while it trains: 100 x (1 - busy / window)
over the traced slice (the cell's number of whole K-step calls and the
readback after them), busy the union of every kernel's, copy's and
fill's interval on the profiler's timeline.  Layer: the device.
Moves: train_crops_per_s."""

UNIT = "%"
LAYER = "device"
MOVES = "train_crops_per_s"


def read(ctx):
    s = ctx["slice"]
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
