"""B1's share of its roofline at the serving shape: the bound of one
block forward at (tile batch, tile, tile, nf) (``flops.rdb_fwd_cost``,
0.0318 ms at (16, 64, 64, 64)) over B1's device time a call in the
traced slice (its kernels, ``kernels/rdb_fwd.json``, counted whole).
Layer: the kernels (``ops/rdb.py``, ``ops/csrc/rdb_fwd*.cu*``).
Moves: serve_output_mp_per_s."""

from port_bench import flops

UNIT = "%"
LAYER = "kernels"
MOVES = "serve_output_mp_per_s"


def read(ctx):
    s = ctx["slice"]
    fam = s and s["families"].get("rdb_fwd")
    if not fam or not fam["calls"] or fam["device_s"] <= 0:
        return None
    run = ctx["run"]
    svc, cfg = run.cell["service"], run.config
    bound = flops.bound_ms(*flops.rdb_fwd_cost(
        svc["tile_batch"], svc["tile"], svc["tile"], cfg["nf"], cfg["gc"],
        cfg["convs_per_rdb"]))
    return 100.0 * bound / (fam["device_s"] * 1e3 / fam["calls"])
