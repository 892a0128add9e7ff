"""Host-side numpy augmentations of the feeder (a copy of the reference
package's ``data/augmentations.py``, the functions the feeder uses).

The reference feeder augmentations (feeders/tools.py) with an explicit
``numpy.random.Generator`` instead of global ``random``/``np.random``
state, so the same seed gives the same batches as the reference package.
Data layout everywhere: (C, T, V, M) float arrays.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def valid_frame_range(data: np.ndarray) -> tuple[int, int]:
    """[begin, end) of frames with any nonzero value (feeders/tools.py:109-112)."""
    valid = (data != 0).sum(axis=(0, 2, 3)) > 0
    if not valid.any():
        return 0, 0
    begin = int(valid.argmax())
    end = int(len(valid) - valid[::-1].argmax())
    return begin, end


def auto_pad(data: np.ndarray, size: int, *,
             random_pad: bool = False,
             rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Zero-pad T up to `size` (reference: feeders/tools.py:32-40)."""
    c, t, v, m = data.shape
    if t >= size:
        return data
    begin = int(rng.integers(0, size - t + 1)) if (random_pad and rng) else 0
    out = np.zeros((c, size, v, m), dtype=data.dtype)
    out[:, begin:begin + t] = data
    return out


def random_choose(data: np.ndarray, size: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Random temporal crop to `size`, or a random-offset pad when shorter
    (reference: feeders/tools.py:43-55)."""
    c, t, v, m = data.shape
    if t == size:
        return data
    if t < size:
        return auto_pad(data, size, random_pad=True, rng=rng)
    begin = int(rng.integers(0, t - size + 1))
    return data[:, begin:begin + size]


def random_shift(data: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Move the valid segment to a random offset in a zero canvas
    (reference: feeders/tools.py:105-117)."""
    c, t, v, m = data.shape
    begin, end = valid_frame_range(data)
    size = end - begin
    out = np.zeros_like(data)
    if size == 0:
        return out
    bias = int(rng.integers(0, t - size + 1))
    out[:, bias:bias + size] = data[:, begin:end]
    return out


def random_move(
    data: np.ndarray,
    rng: np.random.Generator,
    angle_candidate: Sequence[float] = (-10.0, -5.0, 0.0, 5.0, 10.0),
    scale_candidate: Sequence[float] = (0.9, 1.0, 1.1),
    transform_candidate: Sequence[float] = (-0.2, -0.1, 0.0, 0.1, 0.2),
    move_time_candidate: Sequence[int] = (1,),
) -> np.ndarray:
    """Piecewise-interpolated 2D rotate/scale/translate of the (x, y) channels
    (reference: feeders/tools.py:58-102), vectorized over frames."""
    data = data.copy()
    c, t, v, m = data.shape
    move_time = int(rng.choice(np.asarray(move_time_candidate)))
    node = np.append(
        np.arange(0, t, t * 1.0 / move_time).round().astype(int), t)
    num_node = len(node)

    a_k = rng.choice(np.asarray(angle_candidate), num_node)
    s_k = rng.choice(np.asarray(scale_candidate), num_node)
    tx_k = rng.choice(np.asarray(transform_candidate), num_node)
    ty_k = rng.choice(np.asarray(transform_candidate), num_node)

    a = np.zeros(t)
    s = np.zeros(t)
    t_x = np.zeros(t)
    t_y = np.zeros(t)
    for i in range(num_node - 1):
        span = node[i + 1] - node[i]
        a[node[i]:node[i + 1]] = np.linspace(
            a_k[i], a_k[i + 1], span) * np.pi / 180
        s[node[i]:node[i + 1]] = np.linspace(s_k[i], s_k[i + 1], span)
        t_x[node[i]:node[i + 1]] = np.linspace(tx_k[i], tx_k[i + 1], span)
        t_y[node[i]:node[i + 1]] = np.linspace(ty_k[i], ty_k[i + 1], span)

    # (T, 2, 2) rotation+scale, applied to xy per frame
    theta = np.stack([
        np.stack([np.cos(a) * s, -np.sin(a) * s], axis=-1),
        np.stack([np.sin(a) * s, np.cos(a) * s], axis=-1),
    ], axis=-2)  # (T, 2, 2)
    xy = data[0:2]                                  # (2, T, V, M)
    new_xy = np.einsum("tij,jtvm->itvm", theta, xy)
    new_xy[0] += t_x[:, None, None]
    new_xy[1] += t_y[:, None, None]
    data[0:2] = new_xy
    return data
