"""Modality derivation: joint -> bone / motion streams.

Vectorized equivalents of the reference's offline scripts:
- bone: bone[v] = joint[v] - joint[parent(v)], parents from the topology's
  bone-pair table; roots self-reference so their bone is zero
  (reference: data_gen/gen_bone_data.py:41-58,
  gen_bone_data_mediapipe.py:47-67),
- motion: motion[t] = x[t+1] - x[t], last frame zeroed
  (reference: data_gen/gen_motion_data.py:16-31).

These run both offline (gendata CLI, memmap-friendly chunks) and on the fly
in the inference pipeline (reference: inference_pipeline.py:284-309).
"""

from __future__ import annotations

import numpy as np

from shift_gcn_torch.graphs import SkeletonGraph


def joint_to_bone(data: np.ndarray, graph: SkeletonGraph) -> np.ndarray:
    """(..., V, M) joint stream (C,T,V,M layout at axis -2) -> bone stream."""
    parents = graph.bone_parents()
    return data - data[..., parents, :]


def to_motion(data: np.ndarray) -> np.ndarray:
    """(N, C, T, V, M) or (C, T, V, M) -> frame-difference stream."""
    t_axis = data.ndim - 4 + 1  # T axis position for both layouts
    out = np.zeros_like(data)
    src = np.moveaxis(data, t_axis, 0)
    dst = np.moveaxis(out, t_axis, 0)
    dst[:-1] = src[1:] - src[:-1]
    return out


def derive_modalities(joint: np.ndarray, graph: SkeletonGraph) -> dict:
    """All four streams from a joint tensor (reference:
    inference_pipeline.py:284-309)."""
    bone = joint_to_bone(joint, graph)
    return {
        "joint": joint,
        "bone": bone,
        "joint_motion": to_motion(joint),
        "bone_motion": to_motion(bone),
    }
