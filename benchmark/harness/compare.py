"""The comparison that decides ``correct`` in a training cell.

Both sides take the same first steps from the same inputs. Each cell
compares those of these numbers that its workload gives a limit:

  loss_gap     the largest over the steps of |L - L_ref| / |L_ref|
  loss1_gap    the same for the first step alone, the loss before any
               update; the later losses of the pose cell jump where a
               sliver face crosses the raster's least area between two
               sound float32 runs (PERF.md gives the look and readings)
  loss2_gap    the same over the first two steps (read, compared by no cell)
  grad_gap     the first gradient as the optimizer got it, by the worst
               leaf: | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|)
  change_gap   the parameters' change over the steps, by the worst leaf,
               as grad_gap; leaves whose first reference gradient is under
               a thousandth of the median leaf's (they move by round-off
               alone under Adam) are left out
  change_median_gap  the median over those leaves of the same gaps, where
               one quiet leaf's change is Adam's amplified rounding
"""

from __future__ import annotations

import statistics

import torch

ZERO_GRAD = 1e-3  # a leaf under this share of the median leaf's gradient is left out of the change


def norms(tree: dict) -> dict:
    return {k: float(v.detach().double().norm()) for k, v in tree.items()}


def leaf_gaps(got: dict, want: dict, keys=None) -> dict:
    """{leaf: its gap of norms}, each against the larger of its own and the
    median leaf's reference norm."""
    keys = list(want) if keys is None else list(keys)
    med = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys}


def leaf_gap(got: dict, want: dict, keys=None) -> tuple[float, str]:
    """(the worst leaf's gap of norms, its name)."""
    gaps = leaf_gaps(got, want, keys)
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def readings(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [...], "grad": {leaf: norm},
    "change": {leaf: norm}}; returns the numbers and the leaves that set
    the worst gaps."""
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not gaps:
        gaps = [float("inf")]
    grad, grad_leaf = leaf_gap(prog["grad"], ref["grad"])
    med = statistics.median(ref["grad"].values())
    moving = [k for k, v in ref["grad"].items() if v >= ZERO_GRAD * med]
    change, change_leaf = leaf_gap(prog["change"], ref["change"], moving)
    change_median = statistics.median(leaf_gaps(prog["change"], ref["change"], moving).values())
    return {"loss_gaps": gaps, "loss_gap": max(gaps), "loss1_gap": gaps[0], "loss2_gap": max(gaps[:2]),
            "grad_gap": grad, "change_gap": change, "change_median_gap": change_median,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "left_out": sorted(set(ref["grad"]) - set(moving))}


def checks(r: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of the numbers the cell compares: those
    its workload gives a limit."""
    return {k: {"value": r[k], "limit": v} for k, v in limits.items()}


def adam_first_grad(exp_avg: torch.Tensor, beta1: float = 0.9) -> torch.Tensor:
    """The gradient of Adam's first step, from its first moment."""
    return exp_avg / (1.0 - beta1)
