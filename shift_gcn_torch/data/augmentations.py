"""Host-side numpy augmentations (a copy of the reference package's
``data/augmentations.py``): the feeder's, and the reference feeder's
other tools (``downsample``, ``temporal_slice``, ``openpose_match``).

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
                  rng: np.random.Generator,
                  auto_pad_short: bool = True) -> np.ndarray:
    """Random temporal crop to `size`; a shorter clip gets a random-offset
    pad, or is returned as it is without ``auto_pad_short``
    (reference: feeders/tools.py:43-55)."""
    c, t, v, m = data.shape
    if t == size:
        return data
    if t < size:
        if auto_pad_short:
            return auto_pad(data, size, random_pad=True, rng=rng)
        return data
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


def downsample(data: np.ndarray, step: int,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Temporal stride subsample from a random start in [0, step) with
    ``rng``, else from 0 (reference: feeders/tools.py:6-9)."""
    begin = int(rng.integers(0, step)) if rng is not None else 0
    return data[:, begin::step]


def temporal_slice(data: np.ndarray, step: int) -> np.ndarray:
    """Fold time into the person axis by `step`: (C, T, V, M) ->
    (C, T / step, V, step * M); T must be a multiple of `step`
    (reference: feeders/tools.py:12-16)."""
    c, t, v, m = data.shape
    return data.reshape(c, t // step, step, v, m).transpose(
        0, 1, 3, 2, 4).reshape(c, t // step, v, step * m)


def openpose_match(data: np.ndarray) -> np.ndarray:
    """Greedy frame-to-frame person tracking by joint distance, then the
    tracks sorted by confidence (reference: feeders/tools.py:120-161).

    data: (3, T, V, M) with channel 2 the per-joint confidence score.
    """
    c, t, v, m = data.shape
    assert c == 3
    score = data[2].sum(axis=1)                       # (T, M)
    rank = (-score[: t - 1]).argsort(axis=1)          # (T-1, M)

    xy1 = data[0:2, 0:t - 1].reshape(2, t - 1, v, m, 1)
    xy2 = data[0:2, 1:t].reshape(2, t - 1, v, 1, m)
    distance = ((xy2 - xy1) ** 2).sum(axis=2).sum(axis=0)  # (T-1, M, M)

    forward_map = np.zeros((t, m), dtype=int) - 1
    forward_map[0] = range(m)
    for body in range(m):
        choose = rank == body
        forward = distance[choose].argmin(axis=1)
        for ti in range(t - 1):
            distance[ti, :, forward[ti]] = np.inf
        forward_map[1:][choose] = forward
    assert np.all(forward_map >= 0)

    for ti in range(t - 1):
        forward_map[ti + 1] = forward_map[ti + 1][forward_map[ti]]

    new_data = np.zeros_like(data)
    for ti in range(t):
        new_data[:, ti] = data[:, ti, :, forward_map[ti]].transpose(1, 2, 0)

    trace_score = new_data[2].sum(axis=1).sum(axis=0)
    return new_data[:, :, :, (-trace_score).argsort()]
