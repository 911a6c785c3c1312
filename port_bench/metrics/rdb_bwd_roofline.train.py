"""B2's share of its roofline at the training shape: the bound of one
block backward at (batch, crop / scale, crop / scale, nf)
(``flops.rdb_bwd_cost``, 0.0635 ms at (64, 32, 32, 64)) over B2's
device time a call in the traced slice (its kernels,
``kernels/rdb_bwd.json``, counted whole).  Layer: the kernels
(``ops/rdb.py``, ``ops/csrc/rdb_bwd*.cu*``).  Moves: train_crops_per_s."""

from port_bench import flops

UNIT = "%"
LAYER = "kernels"
MOVES = "train_crops_per_s"


def read(ctx):
    s = ctx["slice"]
    fam = s and s["families"].get("rdb_bwd")
    if not fam or not fam["calls"] or fam["device_s"] <= 0:
        return None
    run, w = ctx["run"], ctx["window"]
    cfg = run.config
    lr = w["crop"] // cfg["scale"]
    bound = flops.bound_ms(*flops.rdb_bwd_cost(
        w["batch"], lr, lr, cfg["nf"], cfg["gc"], cfg["convs_per_rdb"]))
    return 100.0 * bound / (fam["device_s"] * 1e3 / fam["calls"])
