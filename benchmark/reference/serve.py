"""The source's fall report of a landmark track, in NumPy and the
reference model.

- windows of ``window`` frames every ``stride`` frames, a last one
  ending at the track's end, zero-padded past it (one padded window for
  a short track);
- per window the source's pre-normalization: all-zero frames removed
  from the front and the tail filled by repeating what is left; the
  mean of the center joints' trajectory of person 0 subtracted from
  every nonzero joint; the whole clip rotated so that frame 0's z bone lies on
  +z, then so that its x bone lies on +x;
- the four streams: joint, bone (joint minus its parent), and the frame
  differences of both (last frame zero);
- per stream the eval forward; the alpha-weighted sum of logits; the
  softmax's fall probability per window; per frame the mean over the
  windows that cover it.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from benchmark.reference.model import FP32, Precision, run_eval

STREAMS = ("joint", "bone", "joint_motion", "bone_motion")


def windows(track: np.ndarray, window: int, stride: int
            ) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    c, t, v, m = track.shape
    starts = list(range(0, max(t - window, 0) + 1, stride)) or [0]
    if starts[-1] + window < t:
        starts.append(t - window)
    out = np.zeros((len(starts), c, window, v, m), np.float32)
    spans = []
    for i, s in enumerate(starts):
        seg = track[:, s:s + window]
        out[i, :, :seg.shape[1]] = seg
        spans.append((s, min(s + window, t)))
    return out, spans


def _rotation(axis: np.ndarray, theta: float) -> np.ndarray:
    """The rotation by ``theta`` about ``axis`` (Euler-Rodrigues)."""
    if np.abs(axis).sum() < 1e-6 or np.abs(theta) < 1e-6:
        return np.eye(3)
    axis = np.asarray(axis, np.float64)
    axis = axis / math.sqrt(np.dot(axis, axis))
    a = math.cos(theta / 2.0)
    b, c, d = -axis * math.sin(theta / 2.0)
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
        [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
        [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c]])


def _angle(v1: np.ndarray, v2: np.ndarray) -> float:
    if np.abs(v1).sum() < 1e-6 or np.abs(v2).sum() < 1e-6:
        return 0.0
    u1 = v1 / np.linalg.norm(v1)
    u2 = v2 / np.linalg.norm(v2)
    return float(np.arccos(np.clip(np.dot(u1, u2), -1.0, 1.0)))


def _fill_null(person: np.ndarray) -> None:
    """person (T, V, C), in place."""
    t = person.shape[0]
    if person.sum() == 0:
        return
    flat = person.reshape(t, -1)
    if flat[0].sum() == 0:
        kept = person[flat.any(axis=1)].copy()
        person[:] = 0
        person[:len(kept)] = kept
    sums = person.reshape(t, -1).sum(axis=1)
    for f in range(t):
        if sums[f] == 0 and sums[f:].sum() == 0:
            reps = int(np.ceil((t - f) / f))
            person[f:] = np.concatenate([person[:f]] * reps)[:t - f]
            break


def pre_normalize(clips: np.ndarray, graph: dict) -> np.ndarray:
    """(N, C, T, V, M) -> a normalized copy."""
    out = np.ascontiguousarray(clips, np.float32).copy()
    s = out.transpose(0, 4, 2, 3, 1)           # a view: (N, M, T, V, C)
    center_joints = graph["center_joint"]
    for skeleton in s:
        if skeleton.sum() == 0:
            continue
        for person in skeleton:
            if person.sum() != 0:
                _fill_null(person)
        center = np.mean([skeleton[0][:, j:j + 1, :] for j in center_joints],
                         axis=0)
        for p in range(len(skeleton)):
            person = skeleton[p]
            if person.sum() == 0:
                continue
            nonzero = (person.sum(-1) != 0)[..., None]
            skeleton[p] = (person - center) * nonzero
        for pair, target in ((graph["zaxis"], np.array([0.0, 0.0, 1.0])),
                             (graph["xaxis"], np.array([1.0, 0.0, 0.0]))):
            bone = skeleton[0, 0, pair[1]] - skeleton[0, 0, pair[0]]
            matrix = _rotation(np.cross(bone, target), _angle(bone, target))
            for p in range(len(skeleton)):
                person = skeleton[p]
                if person.sum() == 0:
                    continue
                mask = person.sum(-1) != 0
                skeleton[p, mask] = person[mask] @ matrix.T
    return out


def streams(joint: np.ndarray, graph: dict) -> dict:
    parents = np.asarray(graph["bone_parents"])
    bone = joint - joint[:, :, :, parents, :]

    def motion(a):
        out = np.zeros_like(a)
        out[:, :, :-1] = a[:, :, 1:] - a[:, :, :-1]
        return out

    return {"joint": joint, "bone": bone, "joint_motion": motion(joint),
            "bone_motion": motion(bone)}


def frame_probabilities(tracks: List[np.ndarray], weights: dict,
                        config: dict, mix: dict, device,
                        prec: Precision = FP32) -> List[np.ndarray]:
    """The per-frame fall probability of each track: its windows'
    softmax over the alpha-weighted logits of the four streams, averaged
    over the windows that cover each frame.  ``weights`` maps a stream
    to its weights."""
    per_track = [windows(t, mix["window"], mix["stride"]) for t in tracks]
    clips = np.concatenate([w for w, _ in per_track])
    joint = pre_normalize(clips, config["graph"])
    inputs = streams(joint, config["graph"])
    total = 0.0
    for stream, alpha in zip(STREAMS, config["alpha"]):
        total = total + alpha * run_eval(weights[stream], inputs[stream],
                                         config, device, prec).astype(
                                             np.float64)
    total = total - total.max(-1, keepdims=True)
    prob = np.exp(total)
    fall = (prob / prob.sum(-1, keepdims=True))[:, 1]
    out, at = [], 0
    for track, (w, spans) in zip(tracks, per_track):
        acc = np.zeros(track.shape[1])
        cnt = np.zeros(track.shape[1])
        for p, (s, e) in zip(fall[at:at + len(w)], spans):
            acc[s:e] += p
            cnt[s:e] += 1
        at += len(w)
        out.append(np.where(cnt > 0, acc / np.maximum(cnt, 1), 0.0))
    return out
