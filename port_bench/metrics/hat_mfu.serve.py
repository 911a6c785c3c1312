"""The served HAT's share of the card's bf16 peak over the measured
window: every request's model FLOPs (a whole-image forward of its LR
pixels, ``flops_hat.generator_flops_per_lr_pixel``: convolutions,
dense layers and both attention products, about 50.7 MFLOP a LR pixel
for SRx4; no tile overlap) over the window's seconds x 989 TFLOP/s.
Measured in the ``--trace 1`` run's window, before its profiled slice.
Layer: the model step (``models/hat.py`` through ``infer/tiled.py``
``TileForward``).  Moves: serve_output_mp_per_s."""

from port_bench import flops, flops_hat

UNIT = "%"
LAYER = "model step"
MOVES = "serve_output_mp_per_s"


def read(ctx):
    w, cfg = ctx["window"], ctx["run"].config
    if not w.get("seconds") or cfg.get("family") != "hat":
        return None
    done = w["lr_pixels"] * flops_hat.generator_flops_per_lr_pixel(cfg)
    return 100.0 * done / w["seconds"] / flops.PEAK_BF16_FLOPS
