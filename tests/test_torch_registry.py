"""The port's model-family registry and the Trainer's family wiring against
the reference package on the CPU: aliases, the keys the port still
refuses (the parallel modes only), the lowering merge and its refusal on
a family without one, dtypes reaching only the families that have them,
and every family training through ``python -m shift_gcn_torch.cli.train``'s
``main``."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from shift_gcn_tpu.models import registry as jax_registry
from shift_gcn_tpu.ops import lowering as jax_lowering
from shift_gcn_torch.cli import train as cli_train
from shift_gcn_torch.models import registry, ring_gnn, shift_gcn, stgcn
from shift_gcn_torch.ops.batchnorm import BatchNorm
from shift_gcn_torch.train import config
from shift_gcn_torch.train.trainer import Trainer

# a 3-unit Shift-GCN and a 2-block ST-GCN on the MediaPipe skeleton
SHIFT_ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
              "graph": "mediapipe_pose",
              "blocks": [[3, 8, 1, False], [8, 16, 2], [16, 16]]}
STGCN_ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
              "graph": "mediapipe_pose", "channels": [8, 16],
              "strides": [1, 2]}


@pytest.fixture(scope="module", autouse=True)
def no_onednn():
    # torch's oneDNN convolution backward corrupts the heap on the CPU once
    # the reference package's compiled XLA code has run in the same process
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = saved


@pytest.fixture
def clean_env(monkeypatch):
    for var, _ in jax_lowering._ENV.values():
        monkeypatch.delenv(var, raising=False)


NAMES = (sorted(jax_registry._REGISTRY) + sorted(jax_registry._ALIASES))


@pytest.mark.parametrize("name", NAMES)
def test_reference_names_resolve_to_the_same_family(name):
    assert registry.get_model(name).name == jax_registry.get_model(name).name


def test_port_paths_and_families():
    for family, module, skeleton in (("shift_gcn", shift_gcn, True),
                                     ("stgcn", stgcn, True),
                                     ("ring_gnn", ring_gnn, False)):
        got = registry.get_model(f"shift_gcn_torch.models.{family}")
        assert got.name == family and got.skeleton == skeleton
        assert got.build is module.Model
    for bad in ("gcn", "shift_gcn_torch.models.gcn", "models.stgcn"):
        with pytest.raises(KeyError, match="unknown model family"):
            registry.get_model(bad)


# the parallel keys alone: data, sequence, tensor parallelism and the
# edge partition are ported (A13, A13b, A13c), but shard_time needs time
# ranks (M >= 2) to shard over, tensor parallelism model ranks that divide
# every sharded width, and the edge partition (the reference trainer's
# refusal) model ranks to carry the edge shards
REFUSED = {"mesh_shape": ([2, 3], "'mesh_shape'.*divisible by 3"),
           "shard_time": (True, "'shard_time'.*needs mesh_shape"),
           "edge_partition": (True, "edge_partition needs mesh_shape "
                              r"\[data, model\] with model >= 2")}


@pytest.mark.parametrize("key", sorted(REFUSED))
def test_check_supported_refuses_only_the_parallel_modes(key):
    value, match = REFUSED[key]
    with pytest.raises(ValueError, match=match):
        config.check_supported(config.ExperimentConfig(**{key: value}))


@pytest.mark.parametrize("overrides", [
    {"lowering": {"exact_xpos": True}},
    {"model_args": {"lowering": {"max_shift": 12}}},
    {"compute_dtype": "bfloat16"},
    {"model": "stgcn"}, {"model": "agcn"},
    {"model": "shift_gcn_tpu.models.ring_gnn"},
    {"fourstream": True, "native_loader": True, "remat": True,
     "use_pallas": True, "sync_bn": False, "edge_strategy": "ring"},
], ids=["lowering", "model_args.lowering", "compute_dtype", "stgcn", "agcn",
        "ring_gnn", "read-or-inert keys"])
def test_check_supported_takes_every_single_device_key(overrides):
    config.check_supported(config.ExperimentConfig(**overrides))


def _dataset(root, n=16, t=32, v=33, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    data = rng.standard_normal((n, 3, t, v, 1)).astype(np.float32) * 0.5
    data[:, 0] += (labels * 0.8 - 0.4)[:, None, None, None].astype(
        np.float32)
    paths = {"data_path": os.path.join(root, f"data{seed}.npy"),
             "label_path": os.path.join(root, f"label{seed}.pkl")}
    np.save(paths["data_path"], data)
    with open(paths["label_path"], "wb") as f:
        pickle.dump(([f"s{i}" for i in range(n)], labels.tolist()), f)
    return paths


def _cfg(tmp_path, **overrides):
    paths = _dataset(str(tmp_path))
    return config.ExperimentConfig(
        Experiment_name="family", work_dir=str(tmp_path / "wd"),
        model_saved_name=str(tmp_path / "sm"), train_feeder_args=paths,
        test_feeder_args=paths, batch_size=8, test_batch_size=8,
        num_epoch=1, base_lr=0.1, device_guard=False, **overrides)


def test_lowering_on_stgcn_raises_the_reference_error(tmp_path, clean_env):
    cfg = _cfg(tmp_path, model="stgcn", model_args=dict(STGCN_ARGS),
               lowering={"bn_lp": True})
    with pytest.raises(ValueError,
                       match="model family 'stgcn' has no lowering surface"):
        Trainer(cfg, device="cpu")
    cfg = _cfg(tmp_path, model="stgcn",
               model_args=dict(STGCN_ARGS, lowering={"max_shift": 4}))
    with pytest.raises(ValueError, match=r"lowering keys \['max_shift'\]"):
        Trainer(cfg, device="cpu")


def test_lowering_merge_resolve_and_snapshot(tmp_path, clean_env,
                                            monkeypatch):
    # model_args.lowering under the top-level lowering (which wins), the
    # SGT_* overrides over both; the snapshot records the resolved dict
    monkeypatch.setenv("SGT_BN_LP_EVAL", "0")
    model_args = dict(SHIFT_ARGS, lowering={"max_shift": 12,
                                            "exact_xpos": True})
    cfg = _cfg(tmp_path, model_args=model_args,
               lowering={"max_shift": 16, "tshift_impl": "conv"},
               compute_dtype="bfloat16")
    trainer = Trainer(cfg, device="cpu")
    want = jax_lowering.as_dict(jax_lowering.resolve(jax_lowering.from_dict(
        {"max_shift": 16, "exact_xpos": True, "tshift_impl": "conv"})))
    assert cfg.lowering == want
    assert want["bn_lp_eval"] is False and want["max_shift"] == 16
    assert trainer.model_config.lowering.max_shift == 16
    assert trainer.model_config.compute_dtype == "bfloat16"
    assert trainer.model.lowering.exact_xpos
    assert not any(m.lp_eval for m in trainer.model.modules()
                   if isinstance(m, BatchNorm))
    with open(os.path.join(trainer.work_dir, "config.yaml")) as f:
        assert yaml.safe_load(f)["lowering"] == want


def test_dtypes_reach_only_families_that_have_them(tmp_path, clean_env):
    trainer = Trainer(_cfg(tmp_path, model="agcn",
                           model_args=dict(STGCN_ARGS),
                           compute_dtype="bfloat16",
                           activation_dtype="bfloat16"), device="cpu")
    assert isinstance(trainer.model, stgcn.Model)
    assert not hasattr(trainer.model_config, "compute_dtype")
    # no activation dtype in the family's config: batches move in fp32
    assert trainer.transfer_dtype == torch.float32
    assert trainer.cfg.lowering == {}


def test_trainer_runs_stgcn_family(tmp_path):
    # the reference's tests/test_model_registry.py::
    # test_trainer_runs_stgcn_family on the port: NTU graph, two blocks
    paths = _dataset(str(tmp_path), v=25)
    cfg = config.ExperimentConfig(
        Experiment_name="stgcn_smoke", work_dir=str(tmp_path / "wd"),
        model_saved_name=str(tmp_path / "sm"), model="stgcn",
        model_args={"num_class": 2, "num_point": 25, "num_person": 1,
                    "graph": "ntu_rgb_d", "channels": [8, 16],
                    "strides": [1, 2]},
        train_feeder_args=paths, test_feeder_args=paths,
        batch_size=8, test_batch_size=8, num_epoch=1, device_guard=False)
    tr = Trainer(cfg, device="cpu")
    m0 = tr.train_epoch(0)
    for e in range(1, 4):
        m = tr.train_epoch(e)
    assert m["loss"] < m0["loss"]
    acc = tr.evaluate(3)
    assert 0.0 <= acc <= 1.0
    # the run's copy of the model source is the family's
    assert os.path.exists(os.path.join(tr.work_dir, "stgcn.py"))


@pytest.mark.parametrize("model,extra", [
    ("agcn", ["--model_args", repr(STGCN_ARGS)]),
    ("shift_gcn", ["--model_args", repr(SHIFT_ARGS), "--lowering",
                   "{exact_xpos: true, max_shift: 12, bn_lp: true}",
                   "--compute_dtype", "bfloat16"]),
], ids=["agcn", "shift_gcn-lowering-compute_dtype"])
def test_cli_trains_family_from_yaml(tmp_path, model, extra, clean_env):
    paths = _dataset(str(tmp_path))
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump({
        "Experiment_name": "run", "model": model,
        "work_dir": str(tmp_path / "wd"),
        "model_saved_name": str(tmp_path / "sm"),
        "train_feeder_args": paths, "test_feeder_args": paths,
        "batch_size": 8, "test_batch_size": 8, "num_epoch": 2,
        "save_interval": 1, "eval_interval": 1, "device_guard": False}))
    best = cli_train.main(["--config", str(path), "--torch-device", "cpu"]
                          + extra)
    assert 0.0 <= best <= 1.0
    assert sorted(os.listdir(tmp_path / "sm" / "run")) == ["run-0-2.pt",
                                                           "run-1-4.pt"]
    # resume rebuilds the same family and continues
    trainer = Trainer(config.load_config(
        ["--config", str(path), "--resume", "auto", "--num_epoch", "3"]
        + extra), device="cpu")
    assert (trainer.start_epoch, trainer.global_step) == (2, 4)


def test_fourstream_follows_the_family(tmp_path):
    # the reference's four-stream path needs a skeleton graph: ST-GCN
    # trains four streams, ring-GNN is refused
    cfg = _cfg(tmp_path, model="stgcn", model_args=dict(STGCN_ARGS),
               fourstream=True)
    trainer = Trainer(cfg, device="cpu")
    assert all(isinstance(m, stgcn.Model) for m in trainer.models.values())
    stats = trainer.train_epoch(0)
    assert np.isfinite(stats["stream_losses"]).all()
    with pytest.raises(ValueError, match="fourstream is not supported"):
        Trainer(dataclasses.replace(
            cfg, model="shift_gcn_tpu.models.ring_gnn", model_args={}),
            device="cpu")
