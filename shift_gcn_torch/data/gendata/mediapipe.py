"""MediaPipe Pose video -> landmarks, through a pluggable backend.

The serving half of the reference's data_gen/mediapipe_gendata.py: the
pipeline and the streaming CLI turn a video into world landmarks
(3, T, 33, 1) float32 through a ``PoseBackend``.  The MediaPipe backend
registers itself on first use and imports ``cv2`` and ``mediapipe`` only
then, so this module imports on hosts that have neither; any other
backend (a stub in tests, another pose estimator) is installed with
``register_backend``.  Dataset generation (label maps, the NTU fall split,
chunked extraction) is not part of the port yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

NUM_JOINT = 33
MAX_BODY = 1
MEDIAPIPE_AXES = dict(zaxis=(23, 11), xaxis=(12, 11), center_joint=(23, 24))

# PoseBackend: video path, max_frame -> world landmarks (3, T, 33, 1)
# float32, or a (world, pixel) tuple with pixel (T, 33, 2) image-space
# coordinates (reference extract_landmarks returns both,
# inference_pipeline.py:58-134), or None when no pose is found.  Consumers
# that only need world coordinates unwrap tuples via `world_landmarks`.
PoseBackend = Callable[[str, int], Optional[np.ndarray]]


def world_landmarks(result):
    """Unwrap a PoseBackend result to world landmarks only."""
    if isinstance(result, tuple):
        return result[0]
    return result


def pixel_landmarks(result) -> Optional[np.ndarray]:
    """Unwrap a PoseBackend result to (T, V, 2) pixel landmarks, if any."""
    if isinstance(result, tuple) and len(result) > 1:
        return result[1]
    return None


_BACKENDS: Dict[str, PoseBackend] = {}


def register_backend(name: str, fn: PoseBackend) -> None:
    _BACKENDS[name] = fn


def get_backend(name: str = "mediapipe") -> PoseBackend:
    if name in _BACKENDS:
        return _BACKENDS[name]
    if name == "mediapipe":
        fn = _make_mediapipe_backend()
        _BACKENDS[name] = fn
        return fn
    raise KeyError(f"unknown pose backend {name!r}; known: {list(_BACKENDS)}")


def _make_mediapipe_backend() -> PoseBackend:
    try:
        import cv2
        import mediapipe as mp
    except ImportError as e:
        raise ImportError(
            "mediapipe/opencv not available in this environment; register a "
            "custom pose backend via register_backend() or run extraction on "
            "a host with mediapipe installed") from e

    def extract(video_path: str, max_frame: int = 300):
        cap = cv2.VideoCapture(video_path)
        if not cap.isOpened():
            return None
        width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        frames: List[np.ndarray] = []
        pixels: List[np.ndarray] = []
        with mp.solutions.pose.Pose(
                static_image_mode=False, model_complexity=1,
                min_detection_confidence=0.5,
                min_tracking_confidence=0.5) as pose:
            while cap.isOpened() and len(frames) < max_frame:
                ok, frame = cap.read()
                if not ok:
                    break
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                result = pose.process(rgb)
                if result.pose_world_landmarks:
                    joints = np.array(
                        [[lm.x, lm.y, lm.z]
                         for lm in result.pose_world_landmarks.landmark],
                        dtype=np.float32)
                else:
                    joints = np.zeros((NUM_JOINT, 3), dtype=np.float32)
                # image-space landmarks for the annotated video's overlay
                # (reference inference_pipeline.py:103-110); zeros when no
                # pose, which the renderer skips
                if result.pose_landmarks:
                    px = np.array(
                        [[lm.x * width, lm.y * height]
                         for lm in result.pose_landmarks.landmark],
                        dtype=np.float32)
                else:
                    px = np.zeros((NUM_JOINT, 2), dtype=np.float32)
                frames.append(joints)
                pixels.append(px)
        cap.release()
        if not frames:
            return None
        data = np.stack(frames).transpose(2, 0, 1)  # (3, T, 33)
        return data[:, :, :, None], np.stack(pixels)

    return extract
