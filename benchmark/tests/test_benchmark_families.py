"""A configuration names its model family, and the harness finds that
family's weights, work counts and plain reference by name.

Shift-GCN's readings are pinned to what the harness gave before families
existed: the weights' bytes from two seeds, the FLOP counts and op lists,
and the reference's three steps at test size (one CPU thread, oneDNN
off).  A second family joins a copy of the benchmark as new files and
entries alone, and runs correct; an unknown family, a configuration that
names the port's model itself, and serving another family are
refused."""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import costs, families, generate, weights
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.tests import toy
from benchmark.tests.test_benchmark_imports import top_level_imports

CONFIGS = ("mediapipe_fall", "ntu60_xsub")

# sha256 over each entry's name, dtype, shape and bytes, in order
WEIGHTS = {
    ("mediapipe_fall", 7):
        "1f57c5092cb2403f2ee8280966c4876e489eadd72cf5966251b17b3ddc2c02b0",
    ("mediapipe_fall", 2 ** 31 + 99):
        "0f252658387bb317e544e82a613af32336f39cf6bad743f2e54bc3b4e69b5f0b",
    ("ntu60_xsub", 7):
        "286449aeb7b5d035bb60a4002e017bab1e33c38b3b52bdbaf783ac37c86ecf7c",
    ("ntu60_xsub", 2 ** 31 + 99):
        "e072f4f2d7f95e24673365558f07c55ad577da3d0c36ce59a42a04c226075dcf",
}
FORWARD_MACS = {"mediapipe_fall": 2355725312.0, "ntu60_xsub": 3569295360.0}
# sha256 of repr(costs.ops(config, clips, itemsize, training))
OPS = {
    ("mediapipe_fall", 64, 2, True):
        "da497e4f6a7adde679055f78a7b665932ed2ff926cdc5e01edc5d10a93b1fc7f",
    ("mediapipe_fall", 64, 4, True):
        "3a410130f787c988fcfd66307657db73a56b23dcb524b0044ced6067febd711b",
    ("mediapipe_fall", 64, 4, False):
        "b02b32a8c1a69d24637ffdd300b99ad96babccf973920ba3176f4716b2f86e7f",
    ("mediapipe_fall", 16, 4, False):
        "ef620f216d28cf8ec3023a1911144c76c96067eeaccf82bce51d41e9c6e50fa1",
    ("ntu60_xsub", 64, 2, True):
        "aab69c22ab9368afd24939dd751609a053c47dccf0e7aa5ab5e5450d584ff3a1",
    ("ntu60_xsub", 64, 4, True):
        "c79f109f95bfc53052a2b69263ba5edd4e843c745d714eb37a7f555e8c848105",
    ("ntu60_xsub", 64, 4, False):
        "4e50b43cda89471f7262e665448adf630b5d52b2b5394f7acbb9ebbe2ddceaef",
    ("ntu60_xsub", 16, 4, False):
        "71f14cc8e424ffa508980681b7e36211e5305f51dfbd618b4d2dd3c6ef37a941",
}
# the reference's three steps at test size from seed 5 on the clips of
# seeds 10-12 (batch 8): each step's loss, the first step's logits
# (sha256 of their float32 bytes), and the control's losses
STEPS = {
    "mediapipe_fall": {
        "losses": ["0x1.1b259a0000000p+0", "0x1.17a2ea0000000p+0",
                   "0x1.69b1dc0000000p+1"],
        "logits":
            "988c3beef15e1ead4511c9b55d6e6aea6a224ff6d9171e9519a5b202b14bc82d",
        "control": ("fp8", ["0x1.2a58080000000p+0", "0x1.13e1700000000p+0",
                            "0x1.714afe0000000p+1"])},
    "ntu60_xsub": {
        "losses": ["0x1.081f940000000p+2", "0x1.165ef00000000p+2",
                   "0x1.15d8d60000000p+2"],
        "logits":
            "18f391e9054ecb6bb448d74d79297cf26980f0d8357ff4ac09ddfe05733596a4",
        "control": ("tf32", ["0x1.0821240000000p+2", "0x1.165c180000000p+2",
                             "0x1.15cdd60000000p+2"])},
}


def config_of(name: str) -> dict:
    return json.loads((toy.ROOT / "benchmark" / "configs"
                       / f"{name}.json").read_text())


def state_sha(state) -> str:
    h = hashlib.sha256()
    for name, t in state.items():
        h.update(name.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.fixture
def one_thread(cpu_torch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name,seed", sorted(WEIGHTS))
def test_shift_gcn_weights_are_the_parents(name, seed):
    config = config_of(name)
    assert "family" not in config and families.name(config) == "shift_gcn"
    assert state_sha(weights.make(config, seed, "cpu")) == \
        WEIGHTS[(name, seed)]


@pytest.mark.parametrize("name", CONFIGS)
def test_shift_gcn_work_counts_are_the_parents(name):
    config = config_of(name)
    assert costs.forward_macs(config) == FORWARD_MACS[name]
    assert costs.step_flops_per_clip(config) == 6 * FORWARD_MACS[name]
    for (of, clips, itemsize, training), digest in OPS.items():
        if of == name:
            listed = costs.ops(config, clips, itemsize, training)
            assert hashlib.sha256(repr(listed).encode()).hexdigest() == \
                digest, (clips, itemsize, training)


@pytest.mark.parametrize("name", CONFIGS)
def test_shift_gcn_reference_steps_are_the_parents(name, one_thread):
    config = toy.small_config(config_of(name))
    state = weights.make(config, 5, "cpu")
    batches = [generate.clips(config, 8, s) for s in (10, 11, 12)]
    lr = config["train"]["base_lr"]
    ref = ref_train.steps(state, batches, config, lr, "cpu")
    pinned = STEPS[name]
    assert [float(x).hex() for x in ref["losses"]] == pinned["losses"]
    assert hashlib.sha256(np.ascontiguousarray(ref["logits"]).tobytes()
                          ).hexdigest() == pinned["logits"]
    precision, losses = pinned["control"]
    low = ref_train.steps(state, batches, config, lr, "cpu",
                          ref_model.Precision(precision))
    assert [float(x).hex() for x in low["losses"]] == losses


@pytest.mark.parametrize("path", sorted(families.HERE.glob("*.py")),
                         ids=lambda p: p.name)
def test_a_family_imports_nothing_of_the_port(path):
    imported = top_level_imports(path) - {"__future__", "benchmark", "math",
                                          "importlib", "pathlib", "typing",
                                          "numpy", "torch"}
    assert not imported, imported


# ---------------------------------------------------------------------------
# a second family, in a copy
# ---------------------------------------------------------------------------


def tree_digest(bench: Path) -> dict:
    return {str(p.relative_to(bench)): hashlib.sha256(p.read_bytes())
            .hexdigest()
            for p in sorted(bench.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts and ".cache" not in p.parts}


def add_toy_family(root: Path) -> None:
    """The files and entries that a new architecture brings: a family, a
    configuration, a mix, limits and the manifest's entries."""
    bench = root / "benchmark"
    (bench / "families" / "toy_stgcn.py").write_text(toy.TOY_FAMILY)
    (bench / "configs" / "toy_stgcn.json").write_text(
        json.dumps(toy.toy_stgcn_config()))
    mix = json.loads((bench / "traffic" / "train_b64.json").read_text())
    (bench / "traffic" / "toy_stgcn_train.json").write_text(json.dumps(mix))
    (bench / "limits" / "toy_stgcn_cell.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-4, "grad_gap": 1e-3,
                    "change_median_gap": 1e-3}}))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "toy_stgcn", "source": "a test", "reduced": [],
        "file": "benchmark/configs/toy_stgcn.json", "why": "a test"})
    manifest["workloads"].append({
        "name": "toy_stgcn_cell", "config": "toy_stgcn",
        "traffic": "toy_stgcn_train", "chips": 1, "why": "a test"})
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if "ntu60_train_b64" in metric.get("workloads", []):
            metric["workloads"].append("toy_stgcn_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


@pytest.fixture
def copy(tmp_path, monkeypatch):
    root = toy.make(tmp_path / "copy")
    monkeypatch.syspath_prepend(str(root))
    for name in [m for m in sys.modules if m.split(".")[0] == "benchmark"]:
        monkeypatch.delitem(sys.modules, name)
    return root


@pytest.fixture
def toy_graph(monkeypatch):
    """The toy configuration's 5-joint graph in the port's registry, for
    this test alone."""
    from shift_gcn_torch.graphs import SkeletonGraph, topology

    inward = tuple(tuple(e) for e in toy.TOY_INWARD)
    monkeypatch.setitem(topology._REGISTRY, "toy5", SkeletonGraph(
        name="toy5", num_nodes=5, bone_pairs=inward, center_joint=(0,),
        zaxis=(0, 1), xaxis=(3, 2), inward=inward))


def test_a_second_family_joins_as_new_files(copy, toy_graph, cpu_torch,
                                            monkeypatch):
    from shift_gcn_torch.train.trainer import Trainer

    from benchmark import manifest, result, run

    before = tree_digest(copy / "benchmark")
    add_toy_family(copy)
    built = []
    init = Trainer.__init__

    def spied(self, cfg, *args, **kwargs):
        built.append(cfg.model)
        init(self, cfg, *args, **kwargs)

    monkeypatch.setattr(Trainer, "__init__", spied)
    cell = manifest.cell("toy_stgcn_cell")
    outcome, device = run.run_cell(cell, 2 ** 31 + 17, 0.5, True,
                                   torch.device("cpu"))
    assert built == ["stgcn"]
    line = result.build(cell, outcome, False, device)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"loss_gap", "grad_gap",
                                   "change_median_gap"}
    # step_mfu.train reads the toy family's FLOPs (peaks of the card's
    # name: a CPU run has none)
    traced = result.build(cell, outcome, True,
                          dict(device, kind="NVIDIA H100 80GB HBM3"))
    flops = 6 * toy.stgcn_macs(cell.config) * outcome.layer["clips_per_s"]
    assert traced["metrics"]["step_mfu.train"]["value"] == pytest.approx(
        100 * flops / 67e12, rel=1e-12)
    after = tree_digest(copy / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == [
        "configs/toy_stgcn.json", "families/toy_stgcn.py",
        "limits/toy_stgcn_cell.json", "traffic/toy_stgcn_train.json"]


def test_the_toy_reference_is_the_ports_stgcn(copy, toy_graph, cpu_torch):
    """The toy family's reference against the port's ST-GCN on the same
    seeded weights, in eval and in training."""
    from shift_gcn_torch.models.stgcn import Model, config_from_args

    from benchmark import weights as copied

    add_toy_family(copy)
    config = toy.toy_stgcn_config()
    state = copied.make(config, 3, "cpu")
    model = Model(config_from_args(config["model_args"]), device="cpu")
    model.load_state_dict(state, strict=True)
    x = torch.from_numpy(generate.clips(config, 4, 1)[0])
    for training in (False, True):
        model.train(training)
        with torch.no_grad():
            port = model(x)
            mine = toy.stgcn_forward(state, x, config, training)
        assert torch.allclose(port, mine, rtol=1e-5,
                              atol=1e-5 * port.abs().max())


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_an_unknown_family_is_refused_when_the_cell_is_loaded(copy):
    from benchmark import manifest

    path = copy / "benchmark" / "configs" / "mediapipe_fall.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    family="agcn_nowhere")))
    with pytest.raises(KeyError, match=r"'agcn_nowhere'.*\['shift_gcn'\]"):
        manifest.cell("fall_train_b64", copy)


def test_a_configuration_that_names_the_model_is_refused(copy, monkeypatch):
    """The model is the family's: a ``train`` block that sets it stops
    the run before a Trainer is built."""
    from shift_gcn_torch.train.trainer import Trainer

    from benchmark import manifest, run

    def built(self, *args, **kwargs):
        raise AssertionError("a Trainer was built")

    monkeypatch.setattr(Trainer, "__init__", built)
    cell = manifest.cell("fall_train_b64", copy)
    cell.config["train"]["model"] = "stgcn"
    with pytest.raises(ValueError, match=r"\['model'\] are set by the "
                       "harness"):
        run.run_cell(cell, 1, 0.1, False, torch.device("cpu"))


def test_serving_another_family_is_refused(copy, monkeypatch):
    """The report path builds Shift-GCN alone; another family's report
    cell, or its control, stops before the pool is made."""
    from benchmark import control, manifest, run
    from benchmark import generate as copied

    def made(*args, **kwargs):
        raise AssertionError("the pool was made")

    monkeypatch.setattr(copied, "tracks", made)
    cell = manifest.cell("fall_report_tracks", copy)
    cell.config["family"] = "toy_stgcn"
    message = r"serves the 'shift_gcn' family alone.*'toy_stgcn'"
    with pytest.raises(ValueError, match=message):
        run.run_cell(cell, 1, 0.1, False, torch.device("cpu"))
    with pytest.raises(ValueError, match=message):
        control.report_readings(cell, 1, torch.device("cpu"))
