"""The training step's share of the card's bf16 peak over the measured
window: the window's steps x the model FLOPs of a step
(``flops.step_flops``: generator, discriminator and VGG19 forward and
backward as the step runs them) over its seconds x 989 TFLOP/s.
Measured in the ``--trace 1`` run's window, before its profiled slice.
Layer: the model step (``train/trainer.py`` ``_multi``,
``train/graphs.py``).  Moves: train_crops_per_s."""

from port_bench import flops

UNIT = "%"
LAYER = "model step"
MOVES = "train_crops_per_s"


def read(ctx):
    w, cfg = ctx["window"], ctx["run"].config
    if not w.get("seconds"):
        return None
    step = flops.step_flops(cfg, w["phase"], w["batch"], w["crop"],
                            cfg.get("vgg_convs"))
    return 100.0 * w["steps"] * step / w["seconds"] / flops.PEAK_BF16_FLOPS
