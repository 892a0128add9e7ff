"""The 2s-AGCN family (``families/agcn2s.py``) and its cell: the
benchmark's reference against the tests' copy of the published forward
pass, the work counts against a hand count at the published shapes, the
cell run at test size in a copy, correct, and each planted fault of
``control_agcn`` refused by the cell's limits."""

import importlib.util
import json
import sys

import numpy as np
import pytest
import torch

from benchmark import families, generate, weights
from benchmark.tests import toy

CELL = "agcn_ntu60_train_b64"
CONFIG = "agcn_ntu60_xsub"
# what the family brought: new files alone, and entries at the ends of
# the manifest's lists
FILES = ["configs/agcn_ntu60_xsub.json", "control_agcn.py",
         "families/agcn2s.py", "limits/agcn_ntu60_train_b64.json",
         "metrics/adjacency_ms.train.py",
         "metrics/adjacency_roofline.train.py",
         "metrics/kernel_names/agcn2s.json",
         "tests/test_benchmark_agcn.py"]
METRICS = ["adjacency_roofline.train", "adjacency_ms.train"]


def config_of(name: str) -> dict:
    return json.loads((toy.ROOT / "benchmark" / "configs"
                       / f"{name}.json").read_text())


def published_reference():
    spec = importlib.util.spec_from_file_location(
        "agcn_reference", toy.ROOT / "tests" / "agcn_reference.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_family_forward_is_the_published_forward(training, cpu_torch):
    config = toy.small_config(config_of(CONFIG))
    family = families.of(config)
    state = weights.make(config, 2 ** 31 + 3, "cpu")
    with torch.no_grad():
        for name, t in state.items():
            if name.endswith("running_var"):
                t.uniform_(0.5, 2.0)
    x = torch.from_numpy(generate.clips(config, 4, 9)[0])
    ref = published_reference()
    with torch.no_grad():
        mine = family.forward(state, x, config, training)
        want = ref.forward(state, x, training,
                           blocks=[tuple(b) for b in config["backbone"]],
                           inward=[tuple(e) for e in
                                   config["graph"]["inward"]])
    # both plain fp32 with the same per-subset loop: a few ulps
    assert torch.allclose(mine, want, rtol=1e-5,
                          atol=1e-5 * float(want.abs().max()))


def test_the_configuration_is_the_published_model():
    config = config_of(CONFIG)
    ref = published_reference()
    assert config["family"] == "agcn2s" and families.of(config).MODEL == \
        "agcn2s"
    assert [tuple(b) for b in config["backbone"]] == list(ref.BLOCKS)
    assert [tuple(e) for e in config["graph"]["inward"]] == \
        list(ref.NTU_INWARD)
    assert config["reduced"] == ["train_clips"]
    assert config["train"]["batch_size"] == 64 and config["frames"] == 300
    names = {name for name, *_ in weights.leaves(config)}
    assert "l1.gcn1.PA" in names and "l1.gcn1.down.0.weight" in names
    assert not any(name.endswith(".A") for name in names)


def test_work_counts_by_hand():
    """At the published shapes, a clip (M=2, V=25, K=3, d = C_out / 4):
    per unit the embeddings, the attention, x @ G_k, conv_d, the down
    conv, the 9-tap conv and the residual conv; and the adjacency's ops
    at batch 64 (N' = 128)."""
    config = config_of(CONFIG)
    family = families.of(config)
    # (T, T', C_in, C_out, a residual conv): l1 has no residual
    units = [(300, 300, 3, 64, False), (300, 300, 64, 64, False),
             (300, 300, 64, 64, False), (300, 300, 64, 64, False),
             (300, 150, 64, 128, True), (150, 150, 128, 128, False),
             (150, 150, 128, 128, False), (150, 75, 128, 256, True),
             (75, 75, 256, 256, False), (75, 75, 256, 256, False)]
    macs = 256 * 60
    for t, t_out, cin, cout, residual in units:
        d = cout // 4
        macs += 2 * 25 * t * cin * 6 * d
        macs += 2 * t * 3 * 25 * 25 * (d + cin)
        macs += 2 * 25 * t * 3 * cin * cout
        macs += 2 * 25 * t * cin * cout if cin != cout else 0
        macs += 2 * 25 * t_out * cout * cout * 9
        macs += 2 * 25 * t_out * cin * cout if residual else 0
    assert family.forward_macs(config) == macs == 19407390360
    ops = family.ops(config, 64, 4, True)
    assert [op for op, _, _ in ops] == ["adjacency", "adjacency_grad"] * 10
    # the embeddings: 128 x 25 nodes a frame, sum of T * 6d over the
    # units 345,600 floats; G and P 128 x 3 x 25 x 25 floats a unit
    emb = 128 * 25 * 345600 * 4
    graph = 128 * 3 * 625 * 4
    fwd = [(b, f) for op, b, f in ops if op == "adjacency"]
    bwd = [(b, f) for op, b, f in ops if op == "adjacency_grad"]
    assert sum(b for b, _ in fwd) == emb + 10 * (graph + 2 * 3 * 625 * 4)
    assert sum(b for b, _ in bwd) == 2 * emb + 10 * 2 * graph
    # 2 N' K V^2 sum(d T): sum over the units of d*T is 57,600
    assert sum(f for _, f in fwd) == 2 * 128 * 3 * 625 * 57600
    assert sum(f for _, f in bwd) == 2 * sum(f for _, f in fwd)
    assert family.ops(config, 64, 4, False) == [
        op for op in ops if op[0] == "adjacency"]


# ---------------------------------------------------------------------------
# the cell in a copy at test size
# ---------------------------------------------------------------------------


@pytest.fixture
def copy(tmp_path, monkeypatch):
    root = toy.make(tmp_path / "copy")
    monkeypatch.syspath_prepend(str(root))
    for name in [m for m in sys.modules if m.split(".")[0] == "benchmark"]:
        monkeypatch.delitem(sys.modules, name)
    return root


def strip(manifest: dict) -> dict:
    """The manifest without what the family brought."""
    out = json.loads(json.dumps(manifest))
    out["configs"] = [c for c in out["configs"] if c["name"] != CONFIG]
    out["workloads"] = [w for w in out["workloads"] if w["name"] != CELL]
    out["per_layer"] = [m for m in out["per_layer"]
                        if m["name"] not in METRICS]
    for metric in out["end_to_end"] + out["per_layer"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].remove(CELL)
    return out


def test_the_family_joins_as_new_files_and_entries(copy):
    bench = copy / "benchmark"
    assert sorted(str(p.relative_to(bench)) for p in bench.rglob("*")
                  if p.is_file() and any(p.match(f) for f in FILES)) == FILES
    manifest = json.loads((copy / "BENCHMARK.json").read_text())
    stripped = strip(manifest)
    for key in ("configs", "workloads", "per_layer"):
        names = [entry["name"] for entry in stripped[key]]
        assert [entry["name"] for entry in manifest[key]][:len(names)] == \
            names
    for full, old in zip(manifest["end_to_end"] + manifest["per_layer"],
                         stripped["end_to_end"] + stripped["per_layer"]):
        if full["name"] in METRICS:
            continue
        listed = full.get("workloads")
        if listed and CELL in listed:
            assert listed[-1] == CELL and listed[:-1] == old["workloads"]
        else:
            assert full == old


def test_the_cell_runs_correct_at_test_size(copy, cpu_torch, monkeypatch):
    from shift_gcn_torch.train.trainer import Trainer

    from benchmark import manifest, result, run

    built = []
    init = Trainer.__init__

    def spied(self, cfg, *args, **kwargs):
        built.append(cfg.model)
        init(self, cfg, *args, **kwargs)

    monkeypatch.setattr(Trainer, "__init__", spied)
    cell = manifest.cell(CELL)
    assert cell.config["backbone"] == toy.SMALL
    outcome, device = run.run_cell(cell, 2 ** 31 + 17, 0.5, True,
                                   torch.device("cpu"))
    assert built == ["agcn2s"]
    line = result.build(cell, outcome, False, device)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == set(cell.limits)
    assert set(line["metrics"]) == {"train_clips_per_s", "peak_gib",
                                    "setup_s"}


def test_each_planted_fault_fails_the_limits(copy, cpu_torch):
    """At test size on the CPU: the sound run within every limit, each of
    the four planted faults (and the harness's own two) past one."""
    from benchmark import checks, control, control_agcn, manifest

    cell = manifest.cell(CELL)
    limits = cell.limits
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(control, "TRAIN_FAULTS",
                   {**control.TRAIN_FAULTS, **control_agcn.FAULTS})
        readings = control.readings(cell, 2 ** 31 + 5, torch.device("cpu"))
    correct, _ = checks.judge(readings["program"], limits)
    assert correct, readings["program"]
    assert set(readings["faults"]) == set(control_agcn.FAULTS) | {
        "unchanged_state", "half_batch"}
    for name, numbers in readings["faults"].items():
        correct, _ = checks.judge(numbers, limits)
        assert not correct, (name, numbers)
    assert np.isfinite(readings["control"]["clip_loss_gap"])
