"""Offline fall-detection pipeline over landmark sequences.

Landmarks (3, T, 33, 1) -> pre-normalized sliding windows -> the four
derived modalities -> one batched forward per stream -> alpha-weighted
logits -> softmax -> per-frame score aggregation -> threshold intervals
-> report dict (reference: inference_pipeline.py:574-670).  The report
has the same keys and semantics as the reference package's.

Video decoding and pose extraction are not part of this module: feed
landmark arrays to ``run_on_landmarks``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from shift_gcn_torch.data.modalities import derive_modalities
from shift_gcn_torch.data.preprocess import pre_normalization
from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.models.shift_gcn import Model, ModelConfig
from shift_gcn_torch.utils.checkpoint import load_reference_checkpoint
from shift_gcn_torch.utils.device import resolve_device

MODALITY_ORDER = ("joint", "bone", "joint_motion", "bone_motion")
DEFAULT_ALPHA = (0.6, 0.6, 0.4, 0.4)

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
        self.config = model_config or ModelConfig(
            num_class=2, num_point=33, num_person=1, graph=graph)
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
