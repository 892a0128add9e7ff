"""Annotated output video (needs ``cv2``, imported on use).

Equivalent of the reference's annotated mp4 writer
(inference_pipeline.py:485-567): per-frame skeleton overlay, a fall
probability bar, and a red tint during detected fall intervals.
Pixel-space landmarks are optional: when only world landmarks exist the
skeleton overlay is skipped and only the probability bar and tint are
drawn.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from shift_gcn_torch.graphs import SkeletonGraph


def render_annotated_video(
    video_path: str,
    output_path: str,
    frame_probs: Sequence[float],
    fall_intervals: Sequence[Dict],
    graph: Optional[SkeletonGraph] = None,
    pixel_landmarks: Optional[np.ndarray] = None,
    threshold: float = 0.5,
) -> str:
    """Write an annotated copy of `video_path` to `output_path`.

    Args:
      frame_probs: per-frame fall probability (len >= frames rendered).
      fall_intervals: dicts with start_frame/end_frame.
      graph: its ``inward`` edges are the skeleton drawn.
      pixel_landmarks: optional (T, V, 2) pixel coordinates for overlay.
    """
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(
        output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))

    in_fall = np.zeros(len(frame_probs), dtype=bool)
    for iv in fall_intervals:
        in_fall[iv["start_frame"]:iv["end_frame"] + 1] = True

    frame_idx = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            prob = float(frame_probs[frame_idx]) if frame_idx < len(
                frame_probs) else 0.0
            falling = frame_idx < len(in_fall) and in_fall[frame_idx]

            if falling:
                tint = frame.copy()
                tint[:, :, 2] = 255
                frame = cv2.addWeighted(frame, 0.7, tint, 0.3, 0)

            if (pixel_landmarks is not None and graph is not None
                    and frame_idx < len(pixel_landmarks)):
                pts = pixel_landmarks[frame_idx]
                for a, b in graph.inward:
                    pa = tuple(int(v) for v in pts[a])
                    pb = tuple(int(v) for v in pts[b])
                    if pa != (0, 0) and pb != (0, 0):
                        cv2.line(frame, pa, pb, (0, 255, 0), 2)

            # probability bar along the bottom
            bar_w = int(prob * (width - 20))
            color = (0, 0, 255) if prob >= threshold else (0, 200, 0)
            cv2.rectangle(frame, (10, height - 30),
                          (10 + bar_w, height - 12), color, -1)
            cv2.putText(frame, f"fall p={prob:.2f}", (10, height - 36),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 2)

            writer.write(frame)
            frame_idx += 1
    finally:
        cap.release()
        writer.release()
    return output_path
