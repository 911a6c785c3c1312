"""The NCCL all-reduce kernels' device time a training step on rank 0's
card: their summed device time in rank 0's traced slice (its whole
K-step calls, ``kernels/nccl_allreduce.json``: every all-reduce inside
the replayed step, counted whole) over the slice's steps.  It holds the
gradients' all-reduce (one a module), the synced BatchNorm's and the
relativistic means'; a kernel's time includes its wait for the other
ranks.  Only data-parallel cells have it.  Layer: the collectives
(``parallel/mesh.py`` ``allreduce_gradients``, ``all_reduce_sum``).
Moves: train_crops_per_s."""

UNIT = "ms"
LAYER = "collectives"
MOVES = "train_crops_per_s"


def read(ctx):
    s = ctx["slice"]
    fam = s and s["families"].get("nccl_allreduce")
    if not fam or not fam["count"] or not s.get("units"):
        return None
    return 1e3 * fam["device_s"] / s["units"]
