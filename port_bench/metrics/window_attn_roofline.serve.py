"""HA's share of its roofline at HAT's serving shape, for the HAB's
window self-attention: the bound of one call at (tile batch, tile,
tile, C) (``flops_hat.attn_bound_ms``: 0.225 ms at (8, 256, 256, 180),
bytes bound) over its kernel's device time a call in the traced slice
(``kernels/window_attn.json``, counted whole: 36 calls a tile batch).
A program without the kernel gives nothing.  Layer: the kernels
(``ops/window_attn.py``, ``ops/csrc/window_attn.cu``).  Moves:
serve_output_mp_per_s."""

from port_bench import flops_hat

UNIT = "%"
LAYER = "kernels"
MOVES = "serve_output_mp_per_s"


def read(ctx):
    s = ctx["slice"]
    fam = s and s["families"].get("window_attn")
    if not fam or not fam["calls"] or fam["device_s"] <= 0:
        return None
    run = ctx["run"]
    bound = flops_hat.attn_bound_ms(run.config, run.cell["service"], False)
    return 100.0 * bound / (fam["device_s"] * 1e3 / fam["calls"])
