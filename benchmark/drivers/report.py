"""Report traffic: one landmark track a request through
``inference.pipeline.run_on_landmarks``, closed loop, one caller.

Set-up makes the pool of tracks (``generate.tracks``) and four streams'
weights from the seed, sets each stream's BN running statistics to the
reference's batch statistics of ``calibration_windows`` windows of the
pool (so that every layer sees unit-scale inputs, as a trained model's
would), builds the ``EnsemblePredictor`` from those state dicts, and
serves one track of every window count the pool holds.  The window
serves whole passes over the pool, in the seed's order, until
``--seconds`` have passed, so that every run serves the same tracks;
each report's latency runs from the call to the report in hand.  A traced run serves the same window with spans around the host's
windowing, pre-normalization and modality derivation, then profiles
``profile_reports`` more reports.  Afterwards the reference recomputes
``check_reports`` reports drawn from the seed among those served, the
longest one included.

Serving is Shift-GCN's: ``EnsemblePredictor`` builds the port's
Shift-GCN, so a configuration of another family is refused before
anything is built.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark import checks, families, generate, weights
from benchmark.reference import model as ref_model
from benchmark.reference import serve as ref_serve
from benchmark.trace import Spans, profile

STREAMS = ref_serve.STREAMS
PREP = ("create_sliding_windows", "pre_normalization", "derive_modalities")
FAMILY = "shift_gcn"      # the only family that the serving pipeline builds


def require_served_family(config: dict) -> None:
    family = families.name(config)
    if family != FAMILY:
        raise ValueError(
            f"the report driver serves the {FAMILY!r} family alone "
            f"(EnsemblePredictor builds Shift-GCN); this configuration's "
            f"family is {family!r}")


def stream_seed(seed: int, k: int) -> int:
    return int(np.random.SeedSequence([int(seed) % 2 ** 63, 100 + k])
               .generate_state(1, np.uint64)[0] % 2 ** 62)


def calibrated_weights(config: dict, mix: dict, pool: List[np.ndarray],
                       seed: int, device) -> Dict[str, dict]:
    """Each stream's state dict: its BN running statistics the batch
    statistics of the first windows of the pool, and its classifier
    scaled so that its logits over those windows have unit spread (a
    trained model's confidence, where the source's initialization would
    saturate every probability)."""
    clips = np.concatenate([ref_serve.windows(t, mix["window"],
                                              mix["stride"])[0]
                            for t in pool])[:mix["calibration_windows"]]
    inputs = ref_serve.streams(
        ref_serve.pre_normalize(clips, config["graph"]), config["graph"])
    out = {}
    for k, stream in enumerate(STREAMS):
        state = weights.make(config, stream_seed(seed, k), device)
        x = ref_model.to_tensor(inputs[stream], device)
        with torch.no_grad(), ref_model.no_tf32():
            ref_model.forward(state, x, config, "calibrate")
            spread = ref_model.forward(state, x, config, False).std()
            state["fc.weight"] /= spread
            state["fc.bias"] /= spread
        out[stream] = state
    return out


def window_count(frames: int, mix: dict) -> int:
    w, s = mix["window"], mix["stride"]
    starts = list(range(0, max(frames - w, 0) + 1, s)) or [0]
    return len(starts) + int(starts[-1] + w < frames)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        workdir: Path):
    from shift_gcn_torch.inference import pipeline
    from shift_gcn_torch.models.shift_gcn import config_from_reference_args

    from benchmark import card
    from benchmark.result import Outcome

    require_served_family(cell.config)
    config, mix = cell.config, cell.traffic
    pool = generate.tracks(config, mix, seed)
    state = calibrated_weights(config, mix, pool, seed, device)
    predictor = pipeline.EnsemblePredictor(
        state, model_config=config_from_reference_args(config["model_args"]),
        alpha=config["alpha"], graph=config["model_args"]["graph"],
        device=device)

    def serve(track):
        return pipeline.run_on_landmarks(
            track, predictor, window=mix["window"], stride=mix["stride"],
            threshold=mix["threshold"])

    # one report of every window count the pool holds
    seen = set()
    for track in pool:
        n = window_count(track.shape[1], mix)
        if n not in seen:
            seen.add(n)
            serve(track)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = card.process_age_s()

    spans = Spans()
    saved = {name: getattr(pipeline, name) for name in PREP}
    if trace:
        for name in PREP:
            setattr(pipeline, name, spans.wrap(name, saved[name]))
    served, latencies, failed = [], [], 0
    t0 = time.perf_counter()
    passes = [t0]
    i = 0
    try:
        # whole passes over the pool, so that every run serves the same
        # tracks, in the seed's order
        while i % len(pool) or time.perf_counter() - t0 < seconds:
            track = pool[i % len(pool)]
            start = time.perf_counter()
            try:
                with spans.span("report"):
                    report = serve(track)
            except (RuntimeError, ValueError, FloatingPointError):
                failed += 1
                report = None
            latencies.append(time.perf_counter() - start)
            if (i + 1) % len(pool) == 0:
                passes.append(time.perf_counter())
            if report is not None:
                served.append((i % len(pool), report))
            i += 1
        elapsed = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        prof = None
        if trace:
            def run_some():
                for j in range(mix["profile_reports"]):
                    with spans.span("report"):
                        serve(pool[(i + j) % len(pool)])
            prof = profile(run_some, mix["profile_reports"], device)
            profiled_windows = [window_count(pool[(i + j) % len(pool)]
                                             .shape[1], mix)
                                for j in range(mix["profile_reports"])]
    finally:
        for name in PREP:
            setattr(pipeline, name, saved[name])
    windows = sum(r["num_windows"] for _, r in served)
    per_pass = windows / max(1, len(passes) - 1)
    print("report passes, windows/s: " + ", ".join(
        f"{per_pass / (b - a):.2f}" for a, b in zip(passes, passes[1:])),
        file=sys.stderr)
    del predictor
    if device.type == "cuda":
        torch.cuda.empty_cache()

    numbers = check(config, mix, pool, served, state, seed, device)
    layer = {"kind": "report", "reports": len(served), "world": 1,
             "windows_per_s": windows / elapsed,
             "spans": dict(spans.seconds)}
    if trace:
        layer["profiles"] = [None if prof is None else prof.summary()]
        layer["profiled_windows"] = profiled_windows
    return Outcome(
        e2e={"report_windows_per_s": windows / elapsed,
             "report_p95_ms": float(np.percentile(latencies, 95)) * 1e3,
             "setup_s": setup_s},
        attempted=len(latencies), failed=failed, numbers=numbers,
        memory_peak_bytes=peak, count=1, layer=layer)


def sample(served: list, count: int, seed: int) -> list:
    """``count`` of the served reports drawn from the seed, with one of
    the longest tracks among them."""
    if not served:
        return []
    rng = generate.rng(seed, 2)
    longest = max(range(len(served)),
                  key=lambda j: served[j][1]["total_frames"])
    picked = set(rng.choice(len(served), min(count, len(served)),
                            replace=False).tolist())
    picked.add(longest)
    return [served[j] for j in sorted(picked)]


def check(config, mix, pool, served, state, seed, device,
          prec=ref_model.FP32) -> dict:
    chosen = sample(served, mix["check_reports"], seed)
    tracks = [pool[k] for k, _ in chosen]
    ref = ref_serve.frame_probabilities(tracks, state, config, mix, device,
                                        prec)
    reports = [dict(r, expected_windows=window_count(t.shape[1], mix))
               for (_, r), t in zip(chosen, tracks)]
    numbers = checks.report_numbers(reports, ref)
    numbers["reports_compared"] = len(chosen)
    return numbers
