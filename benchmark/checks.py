"""The numbers that decide ``correct``, and their limits.

Training (the first steps of the run, against the reference's steps
from the same weights on the same rows).  Leaves whose raw reference
gradient is under a thousandth of the median leaf's (biases ahead of a
BN, xpos) are left out by that rule: they move by round-off alone, and
in bf16 by a gradient that is rounding noise summed over a batch.  Of
the others:

- ``loss_gap``: the largest gap of a step's loss, over the reference's;
  ``loss1_gap`` the first step's alone; ``clip_loss_gap`` the largest
  gap of a clip's loss in the first step (the program's logits for its
  rows: the first ``clips`` rows of the batch, rank 0's on several
  cards), over the reference's mean clip loss, infinite where the
  program gave logits for another number of clips;
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer holds it (g + wd * p after one step), over
  the larger of that leaf's reference norm and the median leaf's;
  ``grad_median_gap`` the median leaf's gap;
- ``change_gap``: the same of each leaf's change after the last step;
  ``change_median_gap`` the median leaf's gap.

Report: ``prob_gap``, the widest gap of a frame's fall probability over
every frame of the sampled reports; ``shape_mismatches``, reports whose
frame or window count differs (exact).

Each cell's limits are in ``limits/<workload>.json``: a number there is
compared, the others are printed only.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

IGNORE_BELOW = 1e-3   # of the median leaf's raw reference gradient


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keys) -> Dict[str, float]:
    keys = list(keys)
    median = float(np.median([ref[k] for k in keys]))
    gaps = {}
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
        gaps[k] = gap if math.isfinite(gap) else math.inf
    return gaps


def _worst(gaps: Dict[str, float]) -> tuple:
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def clip_losses(logits: np.ndarray, labels: np.ndarray) -> np.ndarray:
    z = logits.astype(np.float64)
    z = z - z.max(-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    return -logp[np.arange(len(labels)), labels]


def clip_loss_gap(prog: dict, ref: dict) -> float:
    mine = prog["logits"]
    n = prog.get("clips", len(ref["labels"]))
    if mine.shape[0] != n:
        return math.inf
    theirs = clip_losses(ref["logits"], ref["labels"])
    gap = np.abs(clip_losses(mine, ref["labels"][:n]) - theirs[:n]).max()
    return float(gap / theirs.mean()) if np.isfinite(gap) else math.inf


def train_numbers(prog: dict, ref: dict) -> dict:
    losses = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
              for p, r in zip(prog["losses"], ref["losses"])]
    raw_median = float(np.median(list(ref["raw_grad"].values())))
    moving = [k for k, g in ref["raw_grad"].items()
              if g >= IGNORE_BELOW * raw_median]
    grads = _leaf_gaps(prog["first_grad"], ref["first_grad"], moving)
    changes = _leaf_gaps(prog["change"], ref["change"], moving)
    grad, grad_leaf = _worst(grads)
    change, change_leaf = _worst(changes)
    return {"loss_gap": max(losses), "loss1_gap": losses[0],
            "clip_loss_gap": clip_loss_gap(prog, ref),
            "grad_gap": grad,
            "grad_median_gap": float(np.median(list(grads.values()))),
            "change_gap": change,
            "change_median_gap": float(np.median(list(changes.values()))),
            "_worst": {"grad_gap": grad_leaf, "change_gap": change_leaf,
                       "step_loss_gaps": losses,
                       "left_out": sorted(set(ref["raw_grad"])
                                          - set(moving))}}


def report_numbers(prog: List[dict], ref: List[np.ndarray]) -> dict:
    gap, mismatches = 0.0, 0
    for report, probs in zip(prog, ref):
        mine = np.asarray(report["frame_probabilities"], np.float64)
        if mine.shape != probs.shape or report["num_windows"] != \
                report["expected_windows"]:
            mismatches += 1
            continue
        d = float(np.max(np.abs(mine - probs))) if mine.size else 0.0
        gap = max(gap, d if math.isfinite(d) else math.inf)
    return {"prob_gap": gap, "shape_mismatches": mismatches}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number without one is not compared, and a cell without
    limits is never correct."""
    checks = {}
    correct = bool(limits)
    for name, limit in limits.items():
        value = numbers.get(name)
        if value is None:
            continue
        checks[name] = {"value": value, "limit": limit}
        if not (value <= limit):
            correct = False
    return correct, checks
