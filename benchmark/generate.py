"""Inputs made from the seed: training clips and landmark tracks.

Every seed gets the same sizes: the seed draws the values and the order,
never how much work there is.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def clips(config: dict, n: int, seed: int, stream: int = 0):
    """(n, C, T, V, M) float32 clips of unit-normal coordinates and their
    labels, uniform over the classes."""
    args = config["model_args"]
    shape = (n, config["in_channels"], config["frames"], args["num_point"],
             args["num_person"])
    r = rng(seed, stream)
    data = r.standard_normal(shape, dtype=np.float32)
    labels = r.integers(0, args["num_class"], n)
    return data, labels


def track_lengths(mix: dict) -> List[int]:
    """The pool's lengths: the quantiles of a log-uniform law over
    [frames_min, frames_max], the same for every seed."""
    lo, hi, n = math.log(mix["frames_min"]), math.log(mix["frames_max"]), \
        mix["pool"]
    return [int(round(math.exp(lo + (i + 0.5) / n * (hi - lo))))
            for i in range(n)]


def tracks(config: dict, mix: dict, seed: int) -> List[np.ndarray]:
    """The pool of (C, T, V, 1) float32 landmark tracks, in the seed's
    order.  A track is a body of the configuration's joints that sways
    and drifts (a smooth random walk per joint around a seeded pose),
    with blank frames (all zeros, no person detected) in up to
    ``blank_runs_max`` runs: track i of the pool blanks the share
    blank_share_max * ((7 i mod pool) + 0.5) / pool of its frames."""
    r = rng(seed, 1)
    v = config["model_args"]["num_point"]
    lengths = track_lengths(mix)
    n = len(lengths)
    out = []
    for i in r.permutation(n):
        t = lengths[i]
        pose = r.normal(0.0, 0.3, (1, v, 3))
        walk = np.cumsum(r.normal(0.0, 0.01, (t, v, 3)), axis=0)
        sway = np.cumsum(r.normal(0.0, 0.005, (t, 1, 3)), axis=0)
        track = (pose + walk + sway).astype(np.float32)
        share = mix["blank_share_max"] * (((7 * i) % n) + 0.5) / n
        blank = int(round(share * t))
        runs = int(r.integers(1, mix["blank_runs_max"] + 1))
        cuts = np.sort(r.integers(0, blank + 1, runs - 1))
        sizes = np.diff(np.concatenate([[0], cuts, [blank]]))
        for size in sizes:
            if size:
                start = int(r.integers(0, t - size + 1))
                track[start:start + size] = 0.0
        out.append(np.ascontiguousarray(
            track.transpose(2, 0, 1)[..., None]))
    return out
