"""A configuration, a traffic mix, a per-layer metric and a cell added as
files and entries, in a copy of the benchmark, are run with no other
edit; every Trainer field that they set reaches the Trainer."""

import json
import sys

import pytest
import torch

from benchmark.tests import toy


def add_toy(root):
    bench = root / "benchmark"
    config = json.loads((bench / "configs" / "mediapipe_fall.json")
                        .read_text())
    config["model_args"]["num_class"] = 3
    config["activation_dtype"] = "float32"
    config["train"]["remat"] = True
    (bench / "configs" / "toy_pose.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "train_b64.json").read_text())
    mix["check_steps"] = 2
    mix["experiment"] = {"transfer_dtype": "float32"}
    (bench / "traffic" / "toy_train.json").write_text(json.dumps(mix))
    (bench / "metrics" / "toy_steps.train.py").write_text(
        "def read(ctx):\n"
        "    if ctx.get('kind') != 'train':\n"
        "        return None\n"
        "    return float(ctx['window']['steps'])\n")
    (bench / "limits" / "toy_cell.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-3, "grad_gap": 1e-3}}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "toy_pose", "source": "a test", "reduced": [],
        "file": "benchmark/configs/toy_pose.json", "why": "a test"})
    manifest["workloads"].append({
        "name": "toy_cell", "config": "toy_pose", "traffic": "toy_train",
        "chips": 1, "why": "a test"})
    manifest["per_layer"].append({
        "name": "toy_steps.train", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "trainer and data",
        "moves": "train_clips_per_s", "workloads": ["toy_cell"]})
    for metric in manifest["end_to_end"]:
        if metric["name"] in ("train_clips_per_s", "peak_gib"):
            metric["workloads"].append("toy_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


@pytest.fixture
def copy(tmp_path, monkeypatch):
    root = toy.make(tmp_path / "copy")
    add_toy(root)
    monkeypatch.syspath_prepend(str(root))
    for name in [m for m in sys.modules if m.split(".")[0] == "benchmark"]:
        monkeypatch.delitem(sys.modules, name)
    return root


def test_added_files_are_found_and_run(copy, cpu_torch, monkeypatch):
    from shift_gcn_torch.train.trainer import Trainer

    from benchmark import manifest, result, run

    built = []
    init = Trainer.__init__

    def spied(self, cfg, *args, **kwargs):
        built.append(cfg)
        init(self, cfg, *args, **kwargs)

    monkeypatch.setattr(Trainer, "__init__", spied)
    assert manifest.ROOT == copy
    cell = manifest.cell("toy_cell")
    assert cell.config["model_args"]["num_class"] == 3
    assert cell.traffic["check_steps"] == 2
    assert [m["name"] for m in cell.per_layer] == ["toy_steps.train"]
    outcome, device = run.run_cell(cell, 2 ** 31 + 11, 0.5, True,
                                   torch.device("cpu"))
    assert [(c.remat, c.transfer_dtype) for c in built] == \
        [(True, "float32")]
    line = result.build(cell, outcome, True, device)
    assert line["metrics"]["toy_steps.train"]["value"] == \
        outcome.layer["window"]["steps"] > 0
    assert line["correct"], line["checks"]
    plain = result.build(cell, outcome, False, device)
    assert set(plain["metrics"]) == {"train_clips_per_s", "peak_gib",
                                     "setup_s"}
    assert list(plain)[-1] == "checks"


@pytest.mark.parametrize("block,key", [("config", "rematerialize"),
                                       ("mix", "work_dir")])
def test_a_key_the_trainer_does_not_take_is_refused(copy, tmp_path, block,
                                                    key):
    """A key that is no field of ``ExperimentConfig``, or one that the
    harness sets, stops the run instead of being dropped."""
    from benchmark import manifest
    from benchmark.drivers import train

    cell = manifest.cell("toy_cell")
    if block == "config":
        cell.config["train"][key] = True
    else:
        cell.traffic["experiment"][key] = str(tmp_path)
    with pytest.raises(ValueError, match=key):
        train.experiment(cell, 1, tmp_path,
                         train.write_split(cell.config, 1, tmp_path))
