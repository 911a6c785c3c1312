"""The comparisons that decide ``correct``.

Serving: each checked frame as the service returned it (uint8) against
the reference's, per pixel and channel: ``max_abs_u8``, the largest
difference in levels over the checked frames, and ``mean_abs_u8``, the
mean difference.  A frame of the wrong shape is not correct.

Training, over the first steps (``reference/training.py``
``run_steps``): ``loss_gap``, the largest gap of a step's loss (each
loss a step reports) over the larger of the reference's loss at that
step and at the first step (a loss that falls towards 0 in the first
steps, as a discriminator's does, would otherwise be read relative to
its own rounding); ``loss1_gap``, the same of the first step's losses
alone (the discriminator's first loss comes before any update, so it
holds none of the rounding that the updates amplify); ``grad1_gap``,
the largest gap between the norms of a leaf's first gradient (the
program's worked out from its Adam state after one step, ``exp_avg /
(1 - beta1)``); ``change_gap``, the largest gap between the norms of a
leaf's change over the steps;
``grad1_gap_median`` and ``change_gap_median``, the median leaf's gaps,
and ``grad1_gap_median_<o>`` and ``change_gap_median_<o>`` the same over
one optimizer's leaves (``g``, ``d``: the discriminator's first gradient
comes before any update of the step, the generator's after the
discriminator's first Adam step).
A norm gap is ``| |a| - |r| |`` over the larger of the reference's norm
of that leaf and the median leaf's (per optimizer).  Leaves whose first
gradient in the reference is under a thousandth of the median leaf's
(nought but rounding, such as a bias that a relativistic loss cancels)
are left out of the norm gaps: Adam moves them by round-off alone.
Each cell's ``check`` names the numbers it compares and their limits.
"""

from __future__ import annotations

import statistics

import numpy as np

NEGLIGIBLE = 1e-3


def frames(pairs: list) -> dict:
    """``pairs``: (program uint8 frame, reference uint8 frame) numpy
    arrays."""
    worst, total, count = 0, 0, 0
    for got, ref in pairs:
        if got is None or got.shape != ref.shape:
            return {"max_abs_u8": float("inf"), "mean_abs_u8": float("inf")}
        d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        worst = max(worst, int(d.max()))
        total += int(d.sum(dtype=np.int64))
        count += d.size
    return {"max_abs_u8": float(worst), "mean_abs_u8": total / max(count, 1)}


def _kept(ref_grad: dict) -> list:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= NEGLIGIBLE * med]


def _leaf_gaps(got: dict, ref: dict, keys: list) -> list:
    med = statistics.median(ref[k] for k in keys)
    gaps = [abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]
    return [g if np.isfinite(g) else float("inf") for g in gaps]


def _gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / max(scale, 1e-30) if np.isfinite(a) else float("inf")


def training(got: dict, ref: dict) -> dict:
    """``got`` and ``ref``: ``{"losses", "grad1", "change"}`` as
    ``run_steps`` returns them."""
    first = ref["losses"][0]
    loss_gap = max(_gap(a, b, max(abs(b), abs(b1)))
                   for lg, lr in zip(got["losses"], ref["losses"])
                   for a, b, b1 in zip(lg, lr, first))
    if len(got["losses"]) != len(ref["losses"]):
        loss_gap = float("inf")
    loss1_gap = max(_gap(a, b, abs(b)) for a, b in zip(got["losses"][0],
                                                       first))
    out = {"loss_gap": loss_gap, "loss1_gap": loss1_gap}
    for what in ("grad1", "change"):
        gaps = []
        for opt, ref_grad in ref["grad1"].items():
            mine = _leaf_gaps(got[what][opt], ref[what][opt],
                              _kept(ref_grad))
            out[f"{what}_gap_median_{opt}"] = statistics.median(mine)
            gaps += mine
        out[f"{what}_gap"] = max(gaps)
        out[f"{what}_gap_median"] = statistics.median(gaps)
    return out


def worst_leaves(got: dict, ref: dict) -> dict:
    """The leaf behind each norm gap (for the record)."""
    out = {}
    for what in ("grad1", "change"):
        best = (0.0, "")
        for opt, ref_grad in ref["grad1"].items():
            keys = _kept(ref_grad)
            r, g = ref[what][opt], got[what][opt]
            med = statistics.median(r[k] for k in keys)
            for k in keys:
                best = max(best, (abs(g[k] - r[k]) / max(r[k], med, 1e-30),
                                  f"{opt}:{k} port {g[k]:.6g} ref {r[k]:.6g}"
                                  f" median {med:.6g}"))
        out[what] = best[1]
    return out


def excluded(ref: dict) -> list:
    """The leaves the norm gaps leave out (for the record)."""
    return sorted(f"{opt}:{k}" for opt, g in ref["grad1"].items()
                  for k in set(g) - set(_kept(g)))
