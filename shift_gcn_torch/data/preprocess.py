"""Canonical skeleton pre-normalization.

Behavior-parity re-implementation of reference data_gen/preprocess.py:8-91,
parameterized the same way (NTU defaults zaxis=(0,1), xaxis=(8,4), center=1;
MediaPipe uses zaxis=(23,11), xaxis=(12,11), center=(23,24) — see
data_gen/mediapipe_gendata.py:158).  Four sequential stages per sample:

1. null-frame fill: drop leading/interior all-zero frames to the front,
   then cyclically repeat the prefix over the all-zero tail,
2. center subtraction: subtract person-0's center joint(s) trajectory from
   every person, masked so all-zero joints stay zero,
3. z-axis alignment: rotate so person-0/frame-0's zaxis bone is parallel to
   +z (same rotation applied to every person, masked),
4. x-axis alignment: same for the xaxis bone and +x.

Operates in place on a (N, C=3, T, V, M) float array and returns it.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

from shift_gcn_torch.data.rotation import angle_between, rotation_matrix

Center = Union[int, Sequence[int]]


def _fill_null_frames(person: np.ndarray) -> None:
    """Stage 1 on one (T, V, C) person, in place."""
    t = person.shape[0]
    frame_sums = person.reshape(t, -1).sum(axis=1)
    if person.sum() == 0:
        return
    if frame_sums[0] == 0:
        valid = person.reshape(t, -1).any(axis=1)
        tmp = person[valid].copy()
        person[:] = 0
        person[: len(tmp)] = tmp
        frame_sums = person.reshape(t, -1).sum(axis=1)
    for i_f in range(t):
        if frame_sums[i_f] == 0:
            if frame_sums[i_f:].sum() == 0:
                rest = t - i_f
                reps = int(np.ceil(rest / i_f))
                pad = np.concatenate(
                    [person[:i_f] for _ in range(reps)], axis=0)[:rest]
                person[i_f:] = pad
                break


def pre_normalization(
    data: np.ndarray,
    zaxis: Tuple[int, int] = (0, 1),
    xaxis: Tuple[int, int] = (8, 4),
    center_joint: Center = 1,
    verbose: bool = False,
) -> np.ndarray:
    """Normalize (N, C, T, V, M) skeleton data in place; returns the array."""
    n, c, t, v, m = data.shape
    s = np.transpose(data, (0, 4, 2, 3, 1))  # (N, M, T, V, C)

    if verbose:
        print("pad the null frames with the previous frames")
    for i_s, skeleton in enumerate(s):
        if skeleton.sum() == 0:
            if verbose:
                print(i_s, " has no skeleton")
            continue
        for person in skeleton:
            if person.sum() == 0:
                continue
            _fill_null_frames(person)

    if verbose:
        print("subtract the center joint")
    for skeleton in s:
        if skeleton.sum() == 0:
            continue
        if isinstance(center_joint, (list, tuple)):
            center = np.mean(
                [skeleton[0][:, j:j + 1, :] for j in center_joint],
                axis=0).copy()
        else:
            center = skeleton[0][:, center_joint:center_joint + 1, :].copy()
        for i_p, person in enumerate(skeleton):
            if person.sum() == 0:
                continue
            mask = (person.sum(-1) != 0).reshape(t, v, 1)
            skeleton[i_p] = (person - center) * mask

    for axis_pair, target, label in (
            (zaxis, np.array([0.0, 0.0, 1.0]), "z"),
            (xaxis, np.array([1.0, 0.0, 0.0]), "x")):
        if verbose:
            print(f"align bone {axis_pair} to the {label} axis")
        for skeleton in s:
            if skeleton.sum() == 0:
                continue
            joint_a = skeleton[0, 0, axis_pair[0]]
            joint_b = skeleton[0, 0, axis_pair[1]]
            bone = joint_b - joint_a
            rot_axis = np.cross(bone, target)
            angle = angle_between(bone, target)
            matrix = rotation_matrix(rot_axis, angle)
            for i_p, person in enumerate(skeleton):
                if person.sum() == 0:
                    continue
                mask = person.sum(-1) != 0  # (T, V)
                skeleton[i_p, mask] = person[mask] @ matrix.T

    data[:] = np.transpose(s, (0, 4, 2, 3, 1))
    return data
