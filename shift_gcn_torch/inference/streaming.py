"""Online (streaming) fall detection with bounded latency.

The offline pipeline scores a whole recording at once
(``pipeline.run_on_landmarks``; reference inference_pipeline.py:574-670).
For a live camera or landmark feed, where a fall must be flagged within
seconds, this module applies the same per-window semantics to a stream:

- frames are pushed one at a time (``push``) into a ring buffer of the
  last ``window`` frames;
- every ``hop`` frames the trailing window is pre-normalized and scored
  by :meth:`EnsemblePredictor.predict`: one batch-1 forward per stream,
  so each evaluation launches the temporal-shift kernel (K1) 20 times
  and the Shift-GCN kernel (K4) 10 times per stream of the 10-unit
  model, and the detection latency is at most ``hop`` frames plus one
  evaluation;
- threshold crossings are emitted as hysteresis events (``fall_start`` /
  ``fall_end``) the moment they are known, not after the recording ends.

Offline parity: with ``hop == stride`` (and ``window % hop == 0``, true of
the 300/150 defaults) the full windows a stream evaluates are the spans
:func:`create_sliding_windows` builds: evaluations fire at
t = window + k*hop over [k*hop, k*hop + window), and :meth:`finalize`
scores the offline tail window (or, for streams shorter than one window,
the single zero-padded window).  ``finalize``'s report then equals
:func:`run_on_landmarks`' on the same sequence within floating-point
tolerance, not bit for bit: the offline path scores all windows in one
batched forward and the stream one window per forward, and the card's
libraries may sum in another order at another batch size.  The report
adds one streaming-only key, ``final_updates`` (see :meth:`finalize`).
Partial warm-up windows (t < window) are scored for live events but left
out of the per-frame aggregation, so the final report keeps the offline
windowing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from shift_gcn_torch.data.preprocess import pre_normalization
from shift_gcn_torch.inference.pipeline import (
    EnsemblePredictor, build_report)


@dataclasses.dataclass
class StreamUpdate:
    """One scored window, emitted from ``push`` / ``finalize``.

    frame_index: index of the newest frame in the scored window (0-based).
    span: [start, end) frame range the score covers (end == frame_index+1).
    fall_prob: ensembled fall probability of the window.
    fall_active: hysteresis state AFTER this update.
    event: 'fall_start' | 'fall_end' | None: transition at this update.
    partial: True while the buffer has fewer than ``window`` frames (the
        window was zero-padded; left out of the final report's
        aggregation, see the module docstring).
    """

    frame_index: int
    span: Tuple[int, int]
    fall_prob: float
    fall_active: bool
    event: Optional[str]
    partial: bool


class StreamingFallDetector:
    """Bounded-latency fall detection over a live landmark stream.

    Parameters
    ----------
    predictor: a ready :class:`EnsemblePredictor` (any modality subset).
    window: frames per scored window (model T; reference default 300).
    hop: frames between evaluations; detection latency is <= hop frames
        + one evaluation.  Set ``hop == stride`` of the offline pipeline
        for report parity with :func:`run_on_landmarks`.
    threshold: fall probability threshold (reference default 0.5).
    min_consecutive: evaluations >= threshold required before
        ``fall_start`` fires (hysteresis against single-window spikes);
        a single below-threshold evaluation ends the interval.

    A ``finalize`` whose tail evaluation raises leaves the detector as it
    was, so it can be finalized again (or fed more frames); the reference
    package's detector marks itself finalized before that evaluation.
    """

    def __init__(
        self,
        predictor: EnsemblePredictor,
        *,
        window: int = 300,
        hop: int = 30,
        threshold: float = 0.5,
        min_consecutive: int = 1,
    ):
        if window <= 0 or hop <= 0:
            raise ValueError("window and hop must be positive")
        if window % hop != 0:
            # without this, the first recorded full window starts at
            # (window % hop) and frames before it would silently report
            # probability 0.0: unacceptable in a safety detector
            raise ValueError(
                f"window ({window}) must be a multiple of hop ({hop}) so "
                "full windows tile the stream from frame 0")
        if min_consecutive < 1:
            raise ValueError("min_consecutive must be >= 1")
        self.predictor = predictor
        self.window = int(window)
        self.hop = int(hop)
        self.threshold = float(threshold)
        self.min_consecutive = int(min_consecutive)
        c, v, m = 3, predictor.config.num_point, predictor.config.num_person
        self._frame_shape = (c, v, m)
        # ring buffer of the last `window` frames, time-major for cheap
        # ordered reconstruction: (window, C, V, M)
        self._ring = np.zeros((self.window, c, v, m), np.float32)
        self._t = 0  # total frames pushed
        self._last_eval_t = 0  # t at the most recent evaluation
        self._last_update: Optional[StreamUpdate] = None
        # full-window scores + spans for the offline-parity report
        self._scores: List[float] = []
        self._spans: List[Tuple[int, int]] = []
        # hysteresis state
        self._above_streak = 0
        self._fall_active = False
        self._finalized = False

    # -- internals ---------------------------------------------------------

    def _ordered_window(self) -> Tuple[np.ndarray, Tuple[int, int]]:
        """Trailing window as (C, window, V, M) + its [start, end) span.

        While t < window the tail is zero-padded, matching
        create_sliding_windows' short-sequence window.
        """
        t = self._t
        if t >= self.window:
            idx = (np.arange(t - self.window, t)) % self.window
            frames = self._ring[idx]  # (window, C, V, M), oldest first
            span = (t - self.window, t)
        else:
            frames = np.zeros_like(self._ring)
            frames[:t] = self._ring[:t]
            span = (0, t)
        return np.ascontiguousarray(frames.transpose(1, 0, 2, 3)), span

    def _evaluate(self) -> StreamUpdate:
        """Score the trailing window and advance the hysteresis.  The
        forward runs before any state changes, so a forward that raises
        leaves the detector as it was."""
        data, span = self._ordered_window()
        # _ordered_window returns a fresh buffer either way, so the
        # in-place pre_normalization can mutate it directly (no copy)
        batch = pre_normalization(
            data[None],
            zaxis=self.predictor.graph.zaxis,
            xaxis=self.predictor.graph.xaxis,
            center_joint=list(self.predictor.graph.center_joint))
        prob = float(self.predictor.predict(batch)[0, 1])
        partial = self._t < self.window
        if not partial:
            self._scores.append(prob)
            self._spans.append(span)
        event = None
        if prob >= self.threshold:
            self._above_streak += 1
            if (not self._fall_active
                    and self._above_streak >= self.min_consecutive):
                self._fall_active = True
                event = "fall_start"
        else:
            self._above_streak = 0
            if self._fall_active:
                self._fall_active = False
                event = "fall_end"
        self._last_eval_t = self._t
        self._last_update = StreamUpdate(
            frame_index=self._t - 1, span=span, fall_prob=prob,
            fall_active=self._fall_active, event=event, partial=partial)
        return self._last_update

    # -- public API --------------------------------------------------------

    def push(self, frame: np.ndarray) -> Optional[StreamUpdate]:
        """Ingest one landmark frame (C, V, M); returns a StreamUpdate when
        an evaluation was due (every ``hop`` frames), else None."""
        if self._finalized:
            raise RuntimeError("detector already finalized")
        frame = np.asarray(frame, np.float32)
        if frame.shape != self._frame_shape:
            raise ValueError(
                f"frame shape {frame.shape} != {self._frame_shape}")
        self._ring[self._t % self.window] = frame
        self._t += 1
        if self._t % self.hop == 0:
            return self._evaluate()
        return None

    def finalize(self) -> Dict:
        """End of stream: score the tail window if frames arrived since the
        last evaluation (the offline pipeline's trailing window), then
        return :func:`run_on_landmarks`' report (same keys, and at
        hop == stride the same values within floating-point tolerance)
        plus one extra key ``"final_updates"``: the tail evaluation's
        :class:`StreamUpdate` (if one ran) and, when a fall interval is
        still open at stream end, a closing ``fall_end`` update, both as
        dicts, so events first detectable at finalize time are not lost
        (check ``u["event"]`` the way push() consumers check
        ``update.event``).

        The closing ``fall_end`` is a copy of the last evaluated update
        with ``fall_active`` False and ``event`` "fall_end": its
        ``fall_prob`` is the last evaluated window's score (at or above
        the threshold), not a score below it.

        The detector counts as finalized only once the report is built: a
        tail forward that raises leaves it unchanged and re-finalizable.
        """
        if self._finalized:
            raise RuntimeError("detector already finalized")
        t = self._t
        final_updates: List[StreamUpdate] = []
        if 0 < t < self.window:
            # the whole stream fits one padded window: this IS the offline
            # single window; record it despite partial
            if self._last_eval_t == t:
                # the last push() already scored this exact buffer (t is a
                # hop multiple): reuse it, with no second forward and no
                # double hysteresis count; its event was delivered there
                upd = self._last_update
            else:
                upd = self._evaluate()
                final_updates.append(upd)
            self._scores.append(upd.fall_prob)
            self._spans.append(upd.span)
        elif t >= self.window and (not self._spans
                                   or self._spans[-1][1] < t):
            final_updates.append(self._evaluate())
        if self._fall_active:
            # the stream ended mid-interval: close it so event accounting
            # stays symmetric (every fall_start gets a fall_end)
            self._fall_active = False
            final_updates.append(dataclasses.replace(
                self._last_update, fall_active=False, event="fall_end"))
        report = build_report(self._scores, self._spans, t, self.threshold)
        report["final_updates"] = [
            dataclasses.asdict(u) for u in final_updates]
        self._finalized = True
        return report


def run_stream(
    landmarks: np.ndarray,
    predictor: EnsemblePredictor,
    *,
    window: int = 300,
    hop: int = 30,
    threshold: float = 0.5,
    min_consecutive: int = 1,
    on_update=None,
) -> Tuple[Dict, List[StreamUpdate]]:
    """Replay a recorded (C, T, V, M) landmark array through the online
    detector as if it arrived live.  ``on_update`` (optional callable) is
    invoked with each push-time :class:`StreamUpdate` the moment it is
    produced (the live-alerting hook); finalize-time events land in the
    returned report's ``final_updates``.  Returns (report, updates)."""
    det = StreamingFallDetector(
        predictor, window=window, hop=hop, threshold=threshold,
        min_consecutive=min_consecutive)
    updates: List[StreamUpdate] = []
    for i in range(landmarks.shape[1]):
        upd = det.push(landmarks[:, i])
        if upd is not None:
            updates.append(upd)
            if on_update is not None:
                on_update(upd)
    return det.finalize(), updates


def main(argv=None):
    """CLI: replay a landmark file (or a video, extracted first through
    the pose backend) as a live stream, print fall events as they fire,
    write the final report JSON."""
    import argparse
    import json

    import yaml

    from shift_gcn_torch.inference.pipeline import (
        add_checkpoint_args, load_predictor, resolve_checkpoint_args)
    from shift_gcn_torch.models.shift_gcn import config_from_reference_args

    parser = argparse.ArgumentParser(
        description="online (streaming) fall detection over a recorded "
        "landmark stream")
    parser.add_argument("--landmarks", default=None,
                        help=".npy (3, T, V, M) landmark array to replay")
    parser.add_argument("--video", default=None,
                        help="extract landmarks from this video first "
                        "(pose backend), then replay them as a stream")
    parser.add_argument("--pose-backend", default="mediapipe")
    add_checkpoint_args(parser)
    parser.add_argument("--model-args", default="{}",
                        help="YAML dict of model args (must match "
                        "training); default is the full-size MediaPipe "
                        "fall model")
    parser.add_argument("--window", type=int, default=300)
    parser.add_argument("--hop", type=int, default=30)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--min-consecutive", type=int, default=1)
    parser.add_argument("--output", default="stream_results.json")
    args = parser.parse_args(argv)

    if (args.landmarks is None) == (args.video is None):
        parser.error("pass exactly one of --landmarks / --video")
    model_args = yaml.safe_load(args.model_args) or {}
    model_args.setdefault("num_class", 2)
    model_args.setdefault("num_person", 1)
    # num_point defaults to the graph's joint count (33 for MediaPipe Pose)
    model_args.setdefault("graph", "mediapipe_pose")
    cfg = config_from_reference_args(model_args)
    ckpts, fourstream = resolve_checkpoint_args(parser, args)
    predictor = load_predictor(ckpts, fourstream, model_config=cfg,
                               device=args.device)
    if args.landmarks is not None:
        landmarks = np.load(args.landmarks).astype(np.float32)
    else:
        from shift_gcn_torch.data.gendata.mediapipe import (
            get_backend, world_landmarks)

        result = get_backend(args.pose_backend)(args.video, 100000)
        landmarks = world_landmarks(result)
        if landmarks is None:
            raise RuntimeError(f"no pose extracted from {args.video}")

    def emit(upd: StreamUpdate) -> None:
        if upd.event:
            print(json.dumps({"event": upd.event,
                              "frame": upd.frame_index,
                              "prob": round(upd.fall_prob, 4)}), flush=True)

    report, _ = run_stream(
        landmarks, predictor, window=args.window, hop=args.hop,
        threshold=args.threshold, min_consecutive=args.min_consecutive,
        on_update=emit)
    for u in report["final_updates"]:
        if u["event"]:
            print(json.dumps({"event": u["event"], "frame": u["frame_index"],
                              "prob": round(u["fall_prob"], 4),
                              "at": "finalize"}), flush=True)
    with open(args.output, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("frame_probabilities",)}, indent=2))


if __name__ == "__main__":
    main()
