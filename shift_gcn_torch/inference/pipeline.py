"""Offline fall-detection pipeline: video or landmarks -> report.

Landmarks (3, T, 33, 1) -> pre-normalized sliding windows -> the four
derived modalities -> one batched forward per stream -> alpha-weighted
logits -> softmax -> per-frame score aggregation -> threshold intervals
-> report dict (reference: inference_pipeline.py:574-670).  The report
has the same keys and semantics as the reference package's.

``run_on_landmarks`` takes landmark arrays; ``run_pipeline`` (and the CLI,
``python -m shift_gcn_torch.inference.pipeline``) first extracts them from
a video through a pose backend (``data/gendata/mediapipe.py``) and can
write an annotated video (``inference/render.py``).  Checkpoints are the
port's or the reference's ``.pt`` / ``.pkl`` files, one per modality
(``auto_detect_checkpoints`` finds them under a save-models root), or
one four-stream checkpoint of the port's trainer
(``EnsemblePredictor.from_fourstream_checkpoint``); the models run on
CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from shift_gcn_torch.data.modalities import derive_modalities
from shift_gcn_torch.data.preprocess import pre_normalization
from shift_gcn_torch.ensemble import DEFAULT_ALPHA
from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.models.shift_gcn import Model, ModelConfig
from shift_gcn_torch.utils.checkpoint import (
    _CHECKPOINT_NAME, latest_checkpoint, load_fourstream_checkpoint,
    load_reference_checkpoint)
from shift_gcn_torch.utils.device import resolve_device

MODALITY_ORDER = ("joint", "bone", "joint_motion", "bone_motion")

Checkpoint = Union[str, Mapping[str, torch.Tensor]]


def create_sliding_windows(
    data: np.ndarray, window: int = 300, stride: int = 150
) -> Tuple[np.ndarray, List[Tuple[int, int]]]:
    """(C, T, V, M) raw sequence -> stacked zero-padded windows + spans.

    Matches reference inference_pipeline.py:252-281: windows start every
    `stride` frames; a final short window is zero-padded; sequences shorter
    than `window` yield a single padded window.
    """
    c, t, v, m = data.shape
    starts = list(range(0, max(t - window, 0) + 1, stride))
    if not starts:
        starts = [0]
    elif starts[-1] + window < t:
        starts.append(t - window)
    windows = []
    spans = []
    for s in starts:
        w = np.zeros((c, window, v, m), dtype=np.float32)
        seg = data[:, s:s + window]
        w[:, :seg.shape[1]] = seg
        windows.append(w)
        spans.append((s, min(s + window, t)))
    return np.stack(windows), spans


def aggregate_per_frame(
    window_scores: np.ndarray, spans: Sequence[Tuple[int, int]],
    total_frames: int
) -> np.ndarray:
    """Average overlapping window probabilities into per-frame scores
    (reference: inference_pipeline.py:377-386)."""
    acc = np.zeros(total_frames, dtype=np.float64)
    cnt = np.zeros(total_frames, dtype=np.float64)
    for p, (s, e) in zip(window_scores, spans):
        acc[s:e] += p
        cnt[s:e] += 1
    return np.where(cnt > 0, acc / np.maximum(cnt, 1), 0.0)


@dataclasses.dataclass
class FallInterval:
    start_frame: int
    end_frame: int
    peak_prob: float
    mean_prob: float


def detect_fall_intervals(
    frame_probs: np.ndarray, threshold: float = 0.5,
    min_length: int = 1
) -> List[FallInterval]:
    """Threshold-crossing regions with peak statistics
    (reference: inference_pipeline.py:389-424)."""
    above = frame_probs >= threshold
    intervals: List[FallInterval] = []
    start = None
    for i, flag in enumerate(above):
        if flag and start is None:
            start = i
        elif not flag and start is not None:
            if i - start >= min_length:
                seg = frame_probs[start:i]
                intervals.append(FallInterval(
                    start, i - 1, float(seg.max()), float(seg.mean())))
            start = None
    if start is not None and len(above) - start >= min_length:
        seg = frame_probs[start:]
        intervals.append(FallInterval(
            start, len(above) - 1, float(seg.max()), float(seg.mean())))
    return intervals


class EnsemblePredictor:
    """Four-stream ensemble forward over batched windows.

    ``checkpoints`` maps a modality of MODALITY_ORDER to a reference
    ``.pt`` / ``.pkl`` path or to a state_dict.  Each stream's model runs
    on ``device`` (default CUDA; raises when no GPU is present).
    """

    def __init__(
        self,
        checkpoints: Mapping[str, Checkpoint],
        model_config: Optional[ModelConfig] = None,
        alpha: Sequence[float] = DEFAULT_ALPHA,
        graph: str = "mediapipe_pose",
        device="cuda",
    ):
        self.device = resolve_device(device)
        # a registered topology's joint count (33 for MediaPipe Pose)
        self.config = model_config or ModelConfig(
            num_class=2, num_point=get_graph(graph).num_nodes, num_person=1,
            graph=graph)
        self.graph = get_graph(self.config.graph)
        self.alpha = dict(zip(MODALITY_ORDER, alpha))
        self._models: Dict[str, Model] = {}
        for modality, source in checkpoints.items():
            if modality not in MODALITY_ORDER:
                raise KeyError(f"unknown modality {modality!r}")
            if isinstance(source, str):
                source, _ = load_reference_checkpoint(source)
            model = Model(self.config, device=self.device)
            model.load_state_dict(source, strict=True)
            self._models[modality] = model

    @classmethod
    def from_fourstream_checkpoint(
        cls,
        path: str,
        model_config: Optional[ModelConfig] = None,
        alpha: Sequence[float] = DEFAULT_ALPHA,
        graph: str = "mediapipe_pose",
        device="cuda",
    ) -> "EnsemblePredictor":
        """The ensemble of ONE four-stream checkpoint of the port's
        trainer (``train/fourstream.py``): a ``.pt`` path, or a run's
        save dir, whose newest checkpoint is read (reference package
        pipeline.py:131-172, which reads its stacked Orbax checkpoint)."""
        if os.path.isdir(path):
            latest = latest_checkpoint(path)
            if latest is None:
                raise FileNotFoundError(f"no checkpoints under {path}")
            path = latest
        streams, _ = load_fourstream_checkpoint(path)
        return cls({m: streams[m]["model_state_dict"] for m in MODALITY_ORDER
                    if m in streams}, model_config=model_config, alpha=alpha,
                   graph=graph, device=device)

    def predict(self, windows: np.ndarray) -> np.ndarray:
        """windows: (W, C, T, V, M) pre-normalized joint windows ->
        (W, num_class) ensembled probabilities."""
        mods = derive_modalities(windows, self.graph)
        total = None
        with torch.inference_mode():
            for modality in MODALITY_ORDER:
                if modality not in self._models:
                    continue
                x = torch.from_numpy(
                    np.ascontiguousarray(mods[modality], np.float32)
                ).to(self.device)
                weighted = self._models[modality](x) * self.alpha[modality]
                total = weighted if total is None else total + weighted
            return torch.softmax(total, dim=-1).cpu().numpy()


def build_report(
    window_scores: np.ndarray, spans: Sequence[Tuple[int, int]],
    total_frames: int, threshold: float
) -> Dict:
    """Window fall-scores + spans -> the report dict (reference:
    inference_pipeline.py:638-652)."""
    frame_probs = aggregate_per_frame(
        np.asarray(window_scores, np.float64), spans, total_frames)
    intervals = detect_fall_intervals(frame_probs, threshold)
    return {
        "total_frames": int(total_frames),
        "num_windows": int(len(spans)),
        "fall_detected": bool(intervals),
        "max_fall_probability": float(frame_probs.max())
        if total_frames else 0.0,
        "fall_intervals": [dataclasses.asdict(iv) for iv in intervals],
        "frame_probabilities": frame_probs.tolist(),
    }


def run_on_landmarks(
    landmarks: np.ndarray,
    predictor: EnsemblePredictor,
    *,
    window: int = 300,
    stride: int = 150,
    threshold: float = 0.5,
) -> Dict:
    """Landmarks (3, T, 33, 1) -> fall report dict."""
    total_frames = landmarks.shape[1]
    windows, spans = create_sliding_windows(landmarks, window, stride)
    batch = pre_normalization(
        windows.copy(),
        zaxis=predictor.graph.zaxis, xaxis=predictor.graph.xaxis,
        center_joint=list(predictor.graph.center_joint))
    probs = predictor.predict(batch)
    return build_report(probs[:, 1], spans, total_frames, threshold)


def _has_modality(name: str, modality: str) -> bool:
    norm = name.lower().replace("-", "_")
    if modality in ("joint", "bone"):
        # plain joint/bone must not match the *_motion experiments
        return modality in norm.split("_") and "motion" not in norm
    return modality in norm


def auto_detect_checkpoints(save_dir: str) -> Dict[str, str]:
    """Find the newest checkpoint per modality under a save-models root
    (reference: auto_detect_checkpoint, inference_pipeline.py:28-38).

    Handles two layouts:
    - the port trainer's run dirs:
      <save_dir>/<experiment>/<experiment>-<epoch>-<step>.pt, where the
      experiment name contains the modality ("joint", "bone",
      "joint_motion"/"joint-motion", ...): across all matching run dirs
      the highest (epoch, step) wins;
    - reference torch files: <save_dir>/*_<modality>-<epoch>-<step>.pt:
      the highest epoch wins; a non-numeric epoch token
      ('fall-bone-final.pt') counts as epoch 0.
    The reference package's Orbax run dirs are not read (export them to
    ``.pt`` first; see ``utils/checkpoint.py``).
    """
    found: Dict[str, str] = {}
    if not os.path.isdir(save_dir):
        return found
    entries = sorted(os.listdir(save_dir))
    files = sorted(glob.glob(os.path.join(save_dir, "*.pt")))
    for modality in MODALITY_ORDER:
        best = None
        for entry in entries:
            full = os.path.join(save_dir, entry)
            if not (os.path.isdir(full) and _has_modality(entry, modality)):
                continue
            latest = latest_checkpoint(full)
            if latest:
                m = _CHECKPOINT_NAME.fullmatch(os.path.basename(latest))
                key = (int(m["epoch"]), int(m["step"]))
                if best is None or key > best:
                    best = key
                    found[modality] = latest
        if modality in found:
            continue
        pts = [p for p in files
               if _has_modality(os.path.basename(p).rsplit("-", 2)[0],
                                modality)]
        if pts:
            def epoch_of(p):
                parts = os.path.splitext(os.path.basename(p))[0].rsplit(
                    "-", 2)
                if len(parts) >= 3 and parts[-2].isdigit():
                    return int(parts[-2])
                return 0
            found[modality] = max(pts, key=epoch_of)
    return found


def load_predictor(
    checkpoints: Optional[Mapping[str, Checkpoint]] = None,
    fourstream_checkpoint: Optional[str] = None,
    *,
    model_config: Optional[ModelConfig] = None,
    device="cuda",
) -> EnsemblePredictor:
    """The predictor of exactly one of per-modality ``checkpoints`` or a
    ``fourstream_checkpoint`` (a ``.pt`` or a four-stream run's save
    dir)."""
    if (checkpoints is None) == (fourstream_checkpoint is None):
        raise ValueError(
            "pass exactly one of checkpoints / fourstream_checkpoint")
    if fourstream_checkpoint is not None:
        return EnsemblePredictor.from_fourstream_checkpoint(
            fourstream_checkpoint, model_config=model_config, device=device)
    return EnsemblePredictor(checkpoints, model_config=model_config,
                             device=device)


def run_pipeline(
    video_path: str,
    checkpoints: Optional[Mapping[str, Checkpoint]] = None,
    *,
    fourstream_checkpoint: Optional[str] = None,
    output_json: Optional[str] = None,
    output_video: Optional[str] = None,
    window: int = 300,
    stride: int = 150,
    threshold: float = 0.5,
    pose_backend: str = "mediapipe",
    max_frames: int = 100000,
    model_config: Optional[ModelConfig] = None,
    device="cuda",
) -> Dict:
    """Full video -> report (reference: run_pipeline,
    inference_pipeline.py:574-670).  Models come from exactly one of
    per-modality ``checkpoints`` or a ``fourstream_checkpoint``
    (``load_predictor``).

    The report JSON is written before the annotated video is rendered,
    so a failing render never loses the result, and rewritten with
    ``annotated_video`` once the video exists.  ``output_video``: an
    annotated mp4 (skeleton overlay from the backend's pixel landmarks,
    probability bar, fall-interval tint; reference
    inference_pipeline.py:663-667)."""
    from shift_gcn_torch.data.gendata.mediapipe import (
        get_backend, pixel_landmarks, world_landmarks)

    predictor = load_predictor(checkpoints, fourstream_checkpoint,
                               model_config=model_config, device=device)
    result = get_backend(pose_backend)(video_path, max_frames)
    landmarks = world_landmarks(result)
    if landmarks is None:
        raise RuntimeError(f"no pose could be extracted from {video_path}")
    report = run_on_landmarks(
        landmarks, predictor, window=window, stride=stride,
        threshold=threshold)
    report["video"] = os.path.basename(video_path)
    if output_json:
        with open(output_json, "w") as f:
            json.dump(report, f, indent=2)
    if output_video:
        from shift_gcn_torch.inference.render import render_annotated_video

        render_annotated_video(
            video_path, output_video,
            frame_probs=report["frame_probabilities"],
            fall_intervals=report["fall_intervals"],
            graph=predictor.graph,
            pixel_landmarks=pixel_landmarks(result),
            threshold=threshold)
        report["annotated_video"] = output_video
        if output_json:
            with open(output_json, "w") as f:
                json.dump(report, f, indent=2)
    return report


def add_checkpoint_args(parser) -> None:
    """Install the model-selection CLI args shared by the offline
    pipeline and the streaming CLI (streaming.py)."""
    parser.add_argument("--joint", default=None)
    parser.add_argument("--bone", default=None)
    parser.add_argument("--joint-motion", default=None)
    parser.add_argument("--bone-motion", default=None)
    parser.add_argument("--fourstream", default=None,
                        help="one four-stream checkpoint of the port's "
                        "trainer (.pt, or the run's save dir), in place of "
                        "the per-modality checkpoints")
    parser.add_argument("--save-dir", default=None,
                        help="auto-detect per-modality checkpoints under "
                        "this save-models root (reference "
                        "inference_pipeline.py:28-38)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the models (default cuda; "
                        "'cpu' runs the kernels' plain versions)")


def resolve_checkpoint_args(
        parser, args) -> Tuple[Optional[Dict[str, str]], Optional[str]]:
    """args from :func:`add_checkpoint_args` -> (per-modality checkpoint
    dict, four-stream checkpoint), exactly one of them set, for
    :func:`load_predictor`.  parser.error()s on an unusable
    combination."""
    if args.fourstream is not None:
        given = [flag for flag, value in (
            ("--joint", args.joint), ("--bone", args.bone),
            ("--joint-motion", args.joint_motion),
            ("--bone-motion", args.bone_motion),
            ("--save-dir", args.save_dir)) if value]
        if given:
            parser.error(f"--fourstream takes no per-modality checkpoints "
                         f"({', '.join(given)})")
        return None, args.fourstream
    if args.save_dir:
        ckpts = auto_detect_checkpoints(args.save_dir)
        if not ckpts:
            parser.error(f"no checkpoints found under {args.save_dir}")
        return ckpts, None
    if args.joint is None:
        parser.error("--joint (or --save-dir) is required")
    ckpts = {"joint": args.joint}
    for key in ("bone", "joint_motion", "bone_motion"):
        val = getattr(args, key)
        if val:
            ckpts[key] = val
    return ckpts, None


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="fall-detection inference")
    parser.add_argument("--video", required=True)
    add_checkpoint_args(parser)
    parser.add_argument("--output", default="results.json")
    parser.add_argument("--output-video", default=None,
                        help="write an annotated mp4 here")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--window", type=int, default=300)
    parser.add_argument("--stride", type=int, default=150)
    args = parser.parse_args(argv)
    ckpts, fourstream = resolve_checkpoint_args(parser, args)
    report = run_pipeline(
        args.video, ckpts, fourstream_checkpoint=fourstream,
        output_json=args.output,
        output_video=args.output_video, window=args.window,
        stride=args.stride, threshold=args.threshold, device=args.device)
    print(json.dumps({k: v for k, v in report.items()
                      if k != "frame_probabilities"}, indent=2))


if __name__ == "__main__":
    main()
