"""Training traffic: ``Trainer.train_epoch`` over whole epochs.

Set-up writes the configuration's synthetic split (``train_clips`` clips
and ``val_clips`` for the Trainer's eval feeder, which no timed step
reads) under the run's temporary directory, builds the Trainer from the
configuration's ``train`` block and the mix's ``experiment`` block
(fields of ``ExperimentConfig``; any other key is refused) with the
model of the configuration's family, loads the benchmark's weights into
its model and runs the first ``warmup_steps`` steps of epoch 0.  The
first ``check_steps`` of them are those the reference follows: their
rows, each step's loss, the first gradient as the optimizer holds it
after one step, and the parameters after the last of them are read
through spies that the window's epochs no longer carry.  The window
then runs whole epochs until ``--seconds`` have passed; a traced run
profiles one more epoch.
"""

from __future__ import annotations

import dataclasses
import gc
import pickle
import statistics
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import families, generate, weights
from benchmark.trace import Spans, profile


def write_split(config: dict, seed: int, workdir: Path) -> Dict[str, str]:
    """Write the train and val splits; returns their paths."""
    paths = {}
    for split, n, stream in (("train", config["train_clips"], 0),
                             ("val", config["val_clips"], 1)):
        data, labels = generate.clips(config, n, seed, stream)
        paths[f"{split}_data"] = str(workdir / f"{split}_data.npy")
        paths[f"{split}_label"] = str(workdir / f"{split}_label.pkl")
        np.save(paths[f"{split}_data"], data)
        with open(paths[f"{split}_label"], "wb") as f:
            pickle.dump(([f"clip{i}" for i in range(n)],
                         [int(x) for x in labels]), f)
    return paths


# fields that the harness sets for every run, and no data file may
# (``model`` is the configuration's family's)
HARNESS_FIELDS = ("Experiment_name", "work_dir", "model_saved_name", "seed",
                  "print_log", "log_interval", "test_feeder_args", "model",
                  "model_args", "activation_dtype", "device_guard")


def experiment(cell, seed: int, workdir: Path, paths: Dict[str, str]):
    """The ``ExperimentConfig`` of the cell: the model of the
    configuration's family, the configuration's ``train`` block, then the
    mix's ``experiment`` block over it, each key a field of
    ``ExperimentConfig``; the split's paths join the feeder's
    arguments."""
    from shift_gcn_torch.train.config import ExperimentConfig

    given = {**cell.config["train"], **cell.traffic.get("experiment", {})}
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    unknown = sorted(set(given) - fields)
    owned = sorted(set(given) & set(HARNESS_FIELDS))
    if unknown or owned:
        raise ValueError(
            f"cell {cell.name}: {unknown or owned} "
            + ("are not fields of ExperimentConfig" if unknown
               else "are set by the harness"))
    act = cell.config["activation_dtype"]
    given["train_feeder_args"] = {**given.get("train_feeder_args", {}),
                                  "data_path": paths["train_data"],
                                  "label_path": paths["train_label"]}
    return ExperimentConfig(
        Experiment_name=cell.name, work_dir=str(workdir / "work"),
        model_saved_name=str(workdir / "save"), seed=int(seed),
        print_log=False, log_interval=10 ** 9,
        test_feeder_args={"data_path": paths["val_data"],
                          "label_path": paths["val_label"]},
        model=families.of(cell.config).MODEL,
        model_args=dict(cell.config["model_args"]),
        activation_dtype=None if act == "float32" else act,
        device_guard=False, **given)


class FirstSteps:
    """Spies on the Trainer's first ``n`` steps: the rows of each batch
    (the iterator's), the first step's logits (through a forward hook on
    the model), and through the optimizer's post-step hook the first
    gradient as the optimizer holds it and each leaf's change after step
    n.  With ``stop_after`` the epoch ends after that many steps.
    ``remove`` takes the spies away."""

    def __init__(self, trainer, start: Dict[str, torch.Tensor], n: int,
                 stop_after: Optional[int] = None):
        self.n = n
        self.rows: List[np.ndarray] = []
        self.first: Dict[str, torch.Tensor] = {}
        self.change: Dict[str, torch.Tensor] = {}
        self.iterator = trainer.iterators["train"]
        self.named = list(trainer.model.named_parameters())
        self.optimizer = trainer.optimizer
        self.steps = 0
        original = self.iterator.epoch

        def epoch(e):
            batches = original(e)
            try:
                for i, batch in enumerate(batches):
                    if i == stop_after:
                        return
                    if len(self.rows) < self.n:
                        self.rows.append(np.array(batch[2]))
                    yield batch
            finally:
                batches.close()

        self.iterator.epoch = epoch

        def after_step(optimizer, args, kwargs):
            self.steps += 1
            if self.steps == 1:
                self.first = {
                    name: optimizer.state[p]["momentum_buffer"].norm()
                    for name, p in self.named}
            if self.steps == self.n:
                self.change = {name: (p.detach() - start[name]).norm()
                               for name, p in self.named}

        self.hook = self.optimizer.register_step_post_hook(after_step)
        self.logits = None

        def first_forward(module, inputs, output):
            if self.logits is None and module.training:
                self.logits = output.detach().float().clone()

        self.forward_hook = trainer.model.register_forward_hook(
            first_forward)

    def remove(self) -> None:
        del self.iterator.epoch
        self.hook.remove()
        self.forward_hook.remove()

    def readings(self) -> dict:
        return {"first_grad": {k: float(v) for k, v in self.first.items()},
                "change": {k: float(v) for k, v in self.change.items()},
                "rows": [r.tolist() for r in self.rows],
                "logits": self.logits.cpu().numpy()}


class Session:
    """The Trainer, weights and spies of a training cell."""

    def __init__(self, cell, seed: int, device: torch.device, workdir: Path,
                 paths: Dict[str, str]):
        from shift_gcn_torch.train.trainer import Trainer

        self.cell = cell
        self.trainer = Trainer(experiment(cell, seed, workdir, paths),
                               device=str(device))
        self.device = self.trainer.device
        self.state = weights.make(cell.config, seed, self.device)
        weights.load_into(self.trainer.model, self.state)
        self.epoch = 0
        self.steps_per_epoch = \
            self.trainer.iterators["train"].batches_per_epoch()
        self.batch = self.trainer.cfg.batch_size
        self.lr = self.trainer.cfg.base_lr     # epoch 0's, as the reference's

    def run_epoch(self) -> dict:
        stats = self.trainer.train_epoch(self.epoch)
        self.epoch += 1
        return stats

    def warm_up(self, steps: Optional[int] = None) -> dict:
        """The first ``steps`` steps of epoch 0 (the checked ones where
        None), the checked ones under the spies."""
        start = {k: v.float() for k, v in self.state.items()
                 if weights.trainable(k)}
        n = self.cell.traffic["check_steps"]
        spy = FirstSteps(self.trainer, start, n, stop_after=steps or n)
        try:
            first = self.run_epoch()
        finally:
            spy.remove()
        out = spy.readings()
        out["losses"] = first["losses"][:n]
        out["clips"] = self.batch
        return out

    def restart(self) -> None:
        """Back to the benchmark's weights, no optimizer state, epoch 0."""
        weights.load_into(self.trainer.model, self.state)
        self.trainer.optimizer.state.clear()
        self.epoch = 0

    def close(self) -> None:
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def window(session: Session, seconds: float) -> dict:
    """Whole epochs until ``seconds`` have passed."""
    device = session.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    epochs = []
    t0 = time.perf_counter()
    while True:
        epochs.append(session.run_epoch())
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    steps = len(epochs) * session.steps_per_epoch
    losses = [x for e in epochs for x in e["losses"]]
    return {"seconds": elapsed, "epochs": len(epochs), "steps": steps,
            "clips": steps * session.batch,
            "loader_share": statistics.fmean(
                e["dataloader_share"] for e in epochs),
            "failed": int(sum(not np.isfinite(x) for x in losses)),
            "peak_bytes": int(peak)}


def traced_epoch(session: Session):
    """One more epoch under the profiler (``trace.profile``)."""
    spans = Spans()

    def run():
        with spans.span("train_epoch"):
            session.run_epoch()

    return profile(run, session.steps_per_epoch, session.device)


def reference_batches(rows: List[List[int]], paths: Dict[str, str]):
    data = np.load(paths["train_data"], mmap_mode="r")
    with open(paths["train_label"], "rb") as f:
        _, labels = pickle.load(f)
    labels = np.asarray(labels)
    return [(np.asarray(data[np.asarray(r)]), labels[np.asarray(r)])
            for r in rows]


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        workdir: Path):
    """A training cell on one card: the run's Outcome."""
    from benchmark import card, checks
    from benchmark.reference import train as reference
    from benchmark.result import Outcome

    paths = write_split(cell.config, seed, workdir)
    session = Session(cell, seed, device, workdir, paths)
    first = session.warm_up(cell.traffic["warmup_steps"])
    setup_s = card.process_age_s()
    win = window(session, seconds)
    prof = traced_epoch(session) if trace else None
    steps_per_epoch, batch = session.steps_per_epoch, session.batch
    state = session.state
    session.close()
    rows = first.pop("rows")
    ref = reference.steps(state, reference_batches(rows, paths),
                          cell.config, session.lr, device)
    numbers = checks.train_numbers(first, ref)
    return Outcome(
        e2e={"train_clips_per_s": win["clips"] / win["seconds"],
             "peak_gib": win["peak_bytes"] / 2 ** 30, "setup_s": setup_s},
        attempted=win["steps"], failed=win["failed"], numbers=numbers,
        memory_peak_bytes=win["peak_bytes"], count=1,
        layer={"kind": "train", "window": win,
               "profiles": [None if prof is None else prof.summary()],
               "steps_per_epoch": steps_per_epoch, "batch": batch,
               "clips_per_s": win["clips"] / win["seconds"],
               "dtype": cell.config["activation_dtype"], "world": 1})
