"""The readings that a cell's correctness limits are set from, on the card.

    python -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

For each seed it prints one JSON line: the numbers that the program's
sound run gives (``program``), the control's (the reference computed one
precision below the configuration's, in the program's place:
``control``), and a training cell's planted faults (``faults``): a
step that leaves the state unchanged, and half of each batch left out
(the mean taken over the rest).  A training cell reads the first
checked steps of a fresh Trainer, as the run's set-up does; a report cell serves its pool once
and compares a run's sample.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import tempfile
from pathlib import Path

import torch

from benchmark import card, checks, manifest
from benchmark.reference import model as ref_model

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


@contextlib.contextmanager
def patched(obj, name, make):
    saved = getattr(obj, name)
    setattr(obj, name, make(saved))
    try:
        yield
    finally:
        setattr(obj, name, saved)


def unchanged_state():
    """Each step computes and returns, and moves no parameter."""
    from shift_gcn_torch.train import state

    return patched(state, "train_step", lambda step: (
        lambda model, optimizer, batch, lr, mesh=None:
        step(model, optimizer, batch, 0.0, mesh=mesh)))


def half_batch():
    """Each step sees the first half of its batch."""
    from shift_gcn_torch.train import state

    def make(step):
        def half(model, optimizer, batch, lr, mesh=None):
            return step(model, optimizer,
                        {k: v[:len(v) // 2] for k, v in batch.items()}, lr,
                        mesh=mesh)
        return half
    return patched(state, "train_step", make)


def altered_answer():
    """The last window's probabilities of every report come out
    swapped."""
    from shift_gcn_torch.inference.pipeline import EnsemblePredictor

    def make(predict):
        def altered(self, windows):
            probs = predict(self, windows)
            probs[-1] = probs[-1][::-1].copy()
            return probs
        return altered
    return patched(EnsemblePredictor, "predict", make)


TRAIN_FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch}


def _numbers(nums: dict) -> dict:
    """The numbers, and of a training cell the worst leaves and each
    step's loss gap (``look``)."""
    out = {k: v for k, v in nums.items() if not k.startswith("_")}
    if "_worst" in nums:
        out["look"] = {k: v for k, v in nums["_worst"].items()
                       if k != "left_out"}
    return out


def train_readings(cell, seed: int, device: torch.device,
                   workdir: Path) -> dict:
    from benchmark.drivers import train
    from benchmark.reference import train as reference

    paths = train.write_split(cell.config, seed, workdir)
    session = train.Session(cell, seed, device, workdir, paths)
    program = session.warm_up()
    planted = {}
    for name, fault in TRAIN_FAULTS.items():
        session.restart()
        with fault():
            planted[name] = session.warm_up()
    state, lr = session.state, session.lr
    session.close()
    batches = train.reference_batches(program.pop("rows"), paths)
    ref = reference.steps(state, batches, cell.config, lr, device)
    low = reference.steps(
        state, batches, cell.config, lr, device,
        ref_model.Precision(CONTROL[cell.config["activation_dtype"]]))
    return {"program": _numbers(checks.train_numbers(program, ref)),
            "control": _numbers(checks.train_numbers(low, ref)),
            "faults": {k: _numbers(checks.train_numbers(v, ref))
                       for k, v in planted.items()}}


def report_readings(cell, seed: int, device: torch.device) -> dict:
    from shift_gcn_torch.inference import pipeline
    from shift_gcn_torch.models.shift_gcn import config_from_reference_args

    from benchmark import generate
    from benchmark.drivers import report
    from benchmark.reference import serve as ref_serve

    report.require_served_family(cell.config)
    config, mix = cell.config, cell.traffic
    pool = generate.tracks(config, mix, seed)
    state = report.calibrated_weights(config, mix, pool, seed, device)
    predictor = pipeline.EnsemblePredictor(
        state, model_config=config_from_reference_args(config["model_args"]),
        alpha=config["alpha"], graph=config["model_args"]["graph"],
        device=device)

    def serve_pool():
        return [(k, pipeline.run_on_landmarks(
            t, predictor, window=mix["window"], stride=mix["stride"],
            threshold=mix["threshold"])) for k, t in enumerate(pool)]

    served = serve_pool()
    with altered_answer():
        altered = serve_pool()
    program = report.check(config, mix, pool, served, state, seed, device)
    fault = report.check(config, mix, pool, altered, state, seed, device)
    chosen = report.sample(served, mix["check_reports"], seed)
    tracks = [pool[k] for k, _ in chosen]
    low = ref_serve.frame_probabilities(
        tracks, state, config, mix, device,
        ref_model.Precision(CONTROL[config["serve_dtype"]]))
    ref = ref_serve.frame_probabilities(tracks, state, config, mix, device)
    as_reports = [{"frame_probabilities": p, "num_windows": n,
                   "expected_windows": n}
                  for p, n in zip(low, (report.window_count(t.shape[1], mix)
                                        for t in tracks))]
    return {"program": program,
            "control": checks.report_numbers(as_reports, ref),
            "faults": {"altered_answer": fault}}


def readings(cell, seed: int, device: torch.device) -> dict:
    if cell.traffic["driver"] == "report":
        return report_readings(cell, seed, device)
    workdir = Path(tempfile.mkdtemp(prefix="benchmark-control-"))
    try:
        return train_readings(cell, seed, device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    card.require_cards(cell.chips)
    card.configure_environment()
    for seed in args.seeds:
        out = readings(cell, seed, torch.device("cuda"))
        print(json.dumps({"workload": cell.name, "seed": seed, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
