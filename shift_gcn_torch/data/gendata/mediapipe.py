"""MediaPipe Pose video -> landmarks and skeleton datasets, through a
pluggable backend.

A copy of the reference package's ``data/gendata/mediapipe.py`` (the
reference's data_gen/mediapipe_gendata.py).  The pipeline and the
streaming CLI turn a video into world landmarks (3, T, 33, 1) float32
through a ``PoseBackend``.  The MediaPipe backend registers itself on
first use and imports ``cv2`` and ``mediapipe`` only then, so this module
imports on hosts that have neither; any other backend (a stub in tests,
another pose estimator) is installed with ``register_backend``.

Dataset generation, with the reference's semantics:

- per-video world landmarks -> (3, T, 33, 1) float32, zero frames when
  no pose is detected (mediapipe_gendata.py:46-90);
- NTU fall-detection mode: binary label = (action == 43), xsub/xview
  split, deterministic negative subsampling with ``random.Random(seed)``
  (mediapipe_gendata.py:168-189, 284-353);
- chunked extraction with pre_normalization per chunk on the MediaPipe
  axes (zaxis=(23,11), xaxis=(12,11), center=(23,24),
  mediapipe_gendata.py:277);
- generic label-map mode over a video directory
  (mediapipe_gendata.py:93-165).

  python -m shift_gcn_torch.data.gendata.mediapipe --video-dir <videos> \
      --out-dir ./data/mediapipe (--ntu-mode | --label-map fall:1,walk:0)
"""

from __future__ import annotations

import glob
import os
import pickle
import random
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from shift_gcn_torch.data.gendata.ntu import (
    NTU60_TRAINING_CAMERAS, NTU60_TRAINING_SUBJECTS, parse_filename)
from shift_gcn_torch.data.preprocess import pre_normalization

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


def subsample_negatives(
    videos: Sequence[Tuple[str, int]], ratio: float, seed: int
) -> List[Tuple[str, int]]:
    """Deterministic class balancing (mediapipe_gendata.py:168-189)."""
    positives = [v for v in videos if v[1] == 1]
    negatives = [v for v in videos if v[1] == 0]
    target = int(len(positives) * ratio)
    rng = random.Random(seed)
    if target < len(negatives):
        negatives = rng.sample(negatives, target)
    combined = positives + negatives
    rng.shuffle(combined)
    return combined


def extract_and_save(
    videos: Sequence[Tuple[str, int]],
    out_path: str,
    part: Optional[str],
    *,
    backend: PoseBackend,
    max_frame: int = 300,
    chunk_size: int = 5000,
) -> Optional[Tuple[str, str]]:
    """Extract landmarks, pre-normalize per chunk, save split tensors.

    ``part`` prefixes the output files ("train"/"val"); None writes the
    reference generic-mode names data_joint.npy / label.pkl
    (mediapipe_gendata.py:160-163).
    """
    os.makedirs(out_path, exist_ok=True)
    names: List[str] = []
    labels: List[int] = []
    chunk: List[np.ndarray] = []
    chunk_files: List[str] = []

    def flush() -> None:
        if not chunk:
            return
        n = len(chunk)
        fp = np.zeros((n, 3, max_frame, NUM_JOINT, MAX_BODY), np.float32)
        for i, d in enumerate(chunk):
            t = min(d.shape[1], max_frame)
            fp[i, :, :t] = d[:, :t]
        fp = pre_normalization(fp, **MEDIAPIPE_AXES)
        path = os.path.join(out_path,
                            f"_tmp_{part or 'all'}_chunk{len(chunk_files)}.npy")
        np.save(path, fp)
        chunk_files.append(path)
        chunk.clear()

    for vpath, label in videos:
        data = world_landmarks(backend(vpath, max_frame))
        if data is None:
            continue
        names.append(os.path.basename(vpath))
        labels.append(label)
        chunk.append(data)
        if len(chunk) >= chunk_size:
            flush()
    flush()

    if not chunk_files:
        return None

    sizes = [np.load(f, mmap_mode="r").shape[0] for f in chunk_files]
    total = sum(sizes)
    fp = np.zeros((total, 3, max_frame, NUM_JOINT, MAX_BODY), np.float32)
    offset = 0
    for f, n in zip(chunk_files, sizes):
        fp[offset:offset + n] = np.load(f)
        offset += n
        os.remove(f)

    prefix = f"{part}_" if part else ""
    data_file = os.path.join(out_path, f"{prefix}data_joint.npy")
    label_file = os.path.join(out_path, f"{prefix}label.pkl")
    np.save(data_file, fp)
    with open(label_file, "wb") as f:
        pickle.dump((names, labels), f)
    return data_file, label_file


def gendata_ntu_fall(
    video_dir: str,
    out_path: str,
    *,
    falling_action: int = 43,
    benchmark: str = "xsub",
    subsample_ratio: float = 1.0,
    max_frame: int = 300,
    seed: int = 42,
    video_list: Optional[str] = None,
    backend: Optional[PoseBackend] = None,
) -> None:
    """NTU-video binary fall-detection dataset (mediapipe_gendata.py:284-353)."""
    backend = backend or get_backend()
    extensions = {".avi", ".mp4", ".mkv"}
    if video_list:
        with open(video_list) as f:
            allowed = {line.strip() for line in f if line.strip()}
        files = sorted(os.path.join(video_dir, n) for n in allowed
                       if os.path.isfile(os.path.join(video_dir, n)))
    else:
        files = sorted(
            f for f in glob.glob(os.path.join(video_dir, "*"))
            if os.path.isfile(f)
            and os.path.splitext(f)[1].lower() in extensions)

    train_videos: List[Tuple[str, int]] = []
    val_videos: List[Tuple[str, int]] = []
    for path in files:
        try:
            info = parse_filename(path)
        except (ValueError, IndexError):
            continue
        label = 1 if info["action"] == falling_action else 0
        if benchmark == "xsub":
            istrain = info["subject"] in NTU60_TRAINING_SUBJECTS
        elif benchmark == "xview":
            istrain = info["camera"] in NTU60_TRAINING_CAMERAS
        else:
            raise ValueError(f"unknown benchmark {benchmark!r}")
        (train_videos if istrain else val_videos).append((path, label))

    if subsample_ratio > 0:
        train_videos = subsample_negatives(
            train_videos, subsample_ratio, seed)

    extract_and_save(train_videos, out_path, "train",
                     backend=backend, max_frame=max_frame)
    extract_and_save(val_videos, out_path, "val",
                     backend=backend, max_frame=max_frame)


def resolve_label(
    path: str, label_map: Dict[str, int]
) -> Optional[int]:
    """Label from the parent directory name, else the filename prefix up to
    the first underscore (reference mediapipe_gendata.py:124-136)."""
    parent = os.path.basename(os.path.dirname(path))
    if parent in label_map:
        return label_map[parent]
    stem = os.path.splitext(os.path.basename(path))[0]
    prefix = stem.split("_")[0] if stem else stem
    return label_map.get(prefix)


def gendata_label_map(
    video_dir: str,
    out_path: str,
    label_map: Dict[str, int],
    *,
    split_file: Optional[str] = None,
    part: Optional[str] = None,
    max_frame: int = 300,
    backend: Optional[PoseBackend] = None,
) -> Optional[Tuple[str, str]]:
    """Generic dataset mode: any video directory + class-name -> label map
    (reference mediapipe_gendata.py:93-165).

    Videos are taken from ``split_file`` (basenames, one per line —
    subdirectory-relative paths allowed) or discovered recursively so
    class-per-directory layouts work.  Unlabelable videos are skipped with
    a warning.  Output: {part_}data_joint.npy / {part_}label.pkl.
    """
    backend = backend or get_backend()
    if split_file:
        # a typo'd split path must NOT silently fall back to "every video
        # in the directory" (that would leak val videos into train)
        if not os.path.exists(split_file):
            raise FileNotFoundError(f"split file not found: {split_file}")
        with open(split_file) as f:
            names = [line.strip() for line in f if line.strip()]
        files = [os.path.join(video_dir, n) for n in names]
    else:
        files = sorted(
            f for f in glob.glob(os.path.join(video_dir, "**", "*"),
                                 recursive=True)
            if os.path.isfile(f))
    videos: List[Tuple[str, int]] = []
    for path in files:
        if not os.path.isfile(path):
            print(f"Warning: listed video not found, skipping: {path}")
            continue
        label = resolve_label(path, label_map)
        if label is None:
            print(f"Warning: cannot determine label for {path}, skipping")
            continue
        videos.append((path, label))
    return extract_and_save(videos, out_path, part,
                            backend=backend, max_frame=max_frame)


def parse_label_map(spec: str) -> Dict[str, int]:
    """Parse "name:0,other:1" (reference CLI contract,
    mediapipe_gendata.py:405-410)."""
    out: Dict[str, int] = {}
    for pair in spec.split(","):
        k, v = pair.split(":")
        out[k.strip()] = int(v.strip())
    return out


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="MediaPipe pose data generator")
    parser.add_argument("--video-dir", required=True)
    parser.add_argument("--out-dir", default="./data/mediapipe/")
    parser.add_argument("--ntu-mode", action="store_true")
    parser.add_argument("--benchmark", default="xsub")
    parser.add_argument("--falling-action", type=int, default=43)
    parser.add_argument("--subsample-ratio", type=float, default=1.0)
    parser.add_argument("--max-frame", type=int, default=300)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--video-list", default=None)
    # generic label-map mode (reference mediapipe_gendata.py:380-437)
    parser.add_argument("--label-map", default=None,
                        help='comma-separated "class:label" pairs')
    parser.add_argument("--train-split", default=None)
    parser.add_argument("--val-split", default=None)
    args = parser.parse_args(argv)
    if args.ntu_mode:
        gendata_ntu_fall(
            args.video_dir, args.out_dir,
            falling_action=args.falling_action, benchmark=args.benchmark,
            subsample_ratio=args.subsample_ratio, max_frame=args.max_frame,
            seed=args.seed, video_list=args.video_list)
        return
    if not args.label_map:
        parser.error("--label-map is required when not using --ntu-mode")
    label_map = parse_label_map(args.label_map)
    if args.train_split or args.val_split:
        if args.train_split:
            gendata_label_map(
                args.video_dir, args.out_dir, label_map,
                split_file=args.train_split, part="train",
                max_frame=args.max_frame)
        if args.val_split:
            gendata_label_map(
                args.video_dir, args.out_dir, label_map,
                split_file=args.val_split, part="val",
                max_frame=args.max_frame)
    else:
        gendata_label_map(
            args.video_dir, args.out_dir, label_map,
            max_frame=args.max_frame)


if __name__ == "__main__":
    main()
