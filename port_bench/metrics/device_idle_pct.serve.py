"""The device's idle share while it serves whole requests: 100 x (1 -
busy / window) over the traced slice (one request of each size), busy
the union of every kernel's, copy's and fill's interval on the
profiler's timeline.  Layer: the device.  Moves: serve_output_mp_per_s."""

UNIT = "%"
LAYER = "device"
MOVES = "serve_output_mp_per_s"


def read(ctx):
    s = ctx["slice"]
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
