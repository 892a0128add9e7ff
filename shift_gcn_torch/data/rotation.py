"""3D rotation helpers for skeleton pre-normalization.

Same math as reference data_gen/rotation.py:5-42 (axis-angle Rodrigues
matrix with degenerate guards, clipped angle_between), kept host-side numpy:
pre-normalization is an offline, sequential, mask-heavy pipeline and gains
nothing from the accelerator.
"""

from __future__ import annotations

import numpy as np


def rotation_matrix(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rodrigues rotation matrix about `axis` by `theta` radians; identity
    when the axis or angle is degenerate (reference: rotation.py:10-11)."""
    if np.abs(axis).sum() < 1e-6 or np.abs(theta) < 1e-6:
        return np.eye(3)
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.sqrt(axis @ axis)
    a = np.cos(theta / 2.0)
    b, c, d = -axis * np.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array([
        [aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
        [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
        [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc],
    ])


def angle_between(v1: np.ndarray, v2: np.ndarray) -> float:
    """Angle in radians between two vectors; 0 for near-zero vectors
    (reference: rotation.py:38-42)."""
    if np.abs(v1).sum() < 1e-6 or np.abs(v2).sum() < 1e-6:
        return 0.0
    u1 = v1 / np.linalg.norm(v1)
    u2 = v2 / np.linalg.norm(v2)
    return float(np.arccos(np.clip(np.dot(u1, u2), -1.0, 1.0)))
