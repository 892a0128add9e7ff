"""The port's launch detection (parallel/launch.py) for the cases
tests/test_cli_distributed.py holds the reference CLI to, in the
launchers' own variables; the config check of the parallel layouts; the
mesh's rows and frames; and the feeder's ``pad_to_frames`` and host
shards against the reference package's Feeder and BatchIterator."""

import os
import pickle

import numpy as np
import pytest
import torch

from shift_gcn_tpu.data import feeder as jax_feeder
from shift_gcn_torch.data import feeder
from shift_gcn_torch.parallel import launch
from shift_gcn_torch.parallel.mesh import Mesh, make_mesh
from shift_gcn_torch.train import config


@pytest.mark.parametrize("env", [
    {}, {"WORLD_SIZE": "1"}, {"SLURM_NTASKS": "1"},
    {"OMPI_COMM_WORLD_SIZE": "1"}, {"WORLD_SIZE": "weird"},
    {"SGT_DISTRIBUTED": "0", "WORLD_SIZE": "8"},
    {"SGT_DISTRIBUTED": "false", "SLURM_NTASKS": "8"},
    {"SGT_DISTRIBUTED": " off "}, {"SGT_DISTRIBUTED": "No"}])
def test_single_process_defaults_off(env):
    assert launch.should_init_distributed(env) is False


@pytest.mark.parametrize("env", [
    {"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1",
     "MASTER_ADDR": "10.0.0.1"},
    {"SLURM_NTASKS": "4"}, {"OMPI_COMM_WORLD_SIZE": "2"},
    {"SGT_DISTRIBUTED": "1"}, {"SGT_DISTRIBUTED": "yes"}])
def test_multi_process_launchers_detected(env):
    assert launch.should_init_distributed(env) is True


@pytest.mark.parametrize("env,want", [
    ({}, (0, 1, 0, 1)),
    ({"WORLD_SIZE": "8", "RANK": "5", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "4"}, (5, 8, 1, 4)),
    ({"SLURM_NTASKS": "8", "SLURM_PROCID": "6", "SLURM_LOCALID": "2",
      "SLURM_NNODES": "2"}, (6, 8, 2, 4)),
    ({"OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "3",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1",
      "OMPI_COMM_WORLD_LOCAL_SIZE": "2"}, (3, 4, 1, 2))],
    ids=["none", "torchrun", "slurm", "ompi"])
def test_rank_env_reads_each_launcher(env, want):
    assert tuple(launch.rank_env(env)) == want
    assert launch.rank_device("cuda", env) == torch.device("cuda", want[2])
    assert launch.rank_device("cuda:0", env) == torch.device("cuda", 0)
    assert launch.rank_device("cpu", env) == torch.device("cpu")


def test_init_without_rendezvous_address_raises():
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        launch.init_distributed("cpu", {"WORLD_SIZE": "2", "RANK": "0"})


@pytest.mark.parametrize("overrides", [
    {"mesh_shape": [4, 1]}, {"mesh_shape": [4, 2], "shard_time": True},
    {"mesh_shape": [1, 2], "shard_time": True},
    {"mesh_shape": [2, 1], "fourstream": True},
    {"mesh_shape": [2, 2]}, {"mesh_shape": [1, 4], "fourstream": True},
    # no sharded parameter: any number of model ranks
    {"mesh_shape": [1, 3], "model": "stgcn"}],
    ids=["dp", "dp-seqpar", "seqpar", "fourstream-dp", "tp",
         "fourstream-tp", "stgcn-tp3"])
def test_check_supported_takes_dp_and_seqpar(overrides):
    # --mesh_shape with no value clears a YAML's mesh (README)
    config.check_supported(config.ExperimentConfig(mesh_shape=[]))
    assert make_mesh([]).world == 1
    cfg = config.ExperimentConfig(**overrides)
    config.check_supported(cfg)
    # the one world-size check: a mesh of more ranks than this process
    shape = overrides["mesh_shape"]
    with pytest.raises(ValueError, match="torchrun --nproc-per-node "
                       f"{shape[0] * shape[1]}"):
        make_mesh(shape)


@pytest.mark.parametrize("overrides,match", [
    # tensor parallelism (A13b) is ported: M must divide the widths
    ({"mesh_shape": [2, 3]}, r"'mesh_shape'.*\[64, 128, 256\] are not"),
    # the edge partition (A13c) is ported: the reference trainer's
    # refusals hold, here a mesh without model ranks to carry the edges
    ({"edge_partition": True},
     r"edge_partition needs mesh_shape \[data, model\] with model >= 2"),
    ({"shard_time": True}, "model >= 2"),
    ({"mesh_shape": [4, 1], "shard_time": True}, "model >= 2"),
    ({"mesh_shape": [1, 2], "shard_time": True, "fourstream": True},
     "fourstream"),
    ({"mesh_shape": [2]}, r"\[data, model\]")],
    ids=["tp", "edge", "shard_time-alone", "shard_time-m1",
         "shard_time-fourstream", "bad-shape"])
def test_check_supported_refuses(overrides, match):
    with pytest.raises(ValueError, match=match):
        config.check_supported(config.ExperimentConfig(**overrides))


def test_mesh_rows_and_frames():
    # rank r at divmod(r, M) of a [2, 2] mesh
    got = [(Mesh(2, 2, r).coords, Mesh(2, 2, r).batch_rows(8),
            Mesh(2, 2, r).time_frames(304)) for r in range(4)]
    assert got == [((0, 0), slice(0, 4), slice(0, 152)),
                   ((0, 1), slice(0, 4), slice(152, 304)),
                   ((1, 0), slice(4, 8), slice(0, 152)),
                   ((1, 1), slice(4, 8), slice(152, 304))]
    # two nodes of two data ranks each: a rank's rows of its node's batch
    assert [Mesh(4, 1, r, hosts=2).batch_rows(6) for r in range(4)] == [
        slice(0, 3), slice(3, 6), slice(0, 3), slice(3, 6)]
    x = np.arange(8 * 3 * 304).reshape(8, 3, 304, 1, 1)
    np.testing.assert_array_equal(Mesh(2, 2, 3).local(x, True),
                                  x[4:, :, 152:])
    np.testing.assert_array_equal(Mesh(2, 2, 3).local(x, False), x[4:])
    with pytest.raises(ValueError, match="does not split"):
        Mesh(2, 1, 0).batch_rows(5)
    # without a process group the mesh holds the one process
    assert make_mesh() == make_mesh([]) == Mesh(1, 1)
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh([2, 1])


def _dataset(root, n, t, seed):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, 3, t, 5, 2)).astype(np.float32) + 0.3
    paths = {"data_path": os.path.join(root, f"d{seed}.npy"),
             "label_path": os.path.join(root, f"l{seed}.pkl")}
    np.save(paths["data_path"], data)
    with open(paths["label_path"], "wb") as f:
        pickle.dump(([f"s{i}" for i in range(n)],
                     rng.integers(0, 3, n).tolist()), f)
    return paths


@pytest.mark.parametrize("normalization", [False, True])
def test_pad_to_frames_matches_reference(tmp_path, normalization):
    paths = _dataset(str(tmp_path), 6, 10, 0)
    args = dict(paths, normalization=normalization, pad_to_frames=16)
    ours, ref = feeder.Feeder(**args), jax_feeder.Feeder(**args)
    assert not ours.supports_native_batch()
    for i in range(6):
        got = ours.get(i)
        assert got.shape == (3, 16, 5, 2)
        np.testing.assert_array_equal(got, ref.get(i))
    if normalization:  # empty frames come out of the normalize map
        np.testing.assert_allclose(
            got[:, 10:], np.broadcast_to(-ours.mean_map / ours.std_map,
                                         (3, 6, 5, 2)), rtol=1e-6)
    else:
        assert not got[:, 10:].any()


@pytest.mark.parametrize("shuffle,drop_last,batch", [
    (True, True, 4), (False, False, 3), (False, False, 4)],
    ids=["train", "eval", "eval-padded-batch"])
def test_host_shards_match_reference(tmp_path, shuffle, drop_last, batch):
    # 13 samples over 3 hosts: floor quotas of 4 in training, ceil quotas
    # of 5 in eval (the last host holds 3; with batches of 4 its second
    # batch is all padding)
    paths = _dataset(str(tmp_path), 13, 4, 1)
    args = dict(random_move=True)
    seen = []
    for host in range(3):
        kw = dict(shuffle=shuffle, drop_last=drop_last, seed=7,
                  host_id=host, num_hosts=3)
        ours = feeder.BatchIterator(feeder.Feeder(**paths, **args), batch,
                                    **kw)
        ref = jax_feeder.BatchIterator(jax_feeder.Feeder(**paths, **args),
                                       batch, **kw)
        assert ours.batches_per_epoch() == ref.batches_per_epoch()
        for epoch in (0, 2):
            got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            if epoch == 0:
                seen += [i for _, _, idx, mask in got
                         for i, m in zip(idx, mask) if m > 0]
    if drop_last:  # disjoint, the surplus dropped
        assert len(seen) == len(set(seen)) == 12
    else:          # disjoint and exhaustive
        assert sorted(seen) == list(range(13))


def test_unhealthy_device_raises_on_its_rank(monkeypatch):
    """Under a group the device guard's re-exec would restart one rank
    alone: the rank raises instead."""
    from shift_gcn_torch.train.trainer import Trainer
    from shift_gcn_torch.utils import device_guard

    def unhealthy(**kw):
        raise device_guard.DeviceUnhealthyError("bad")

    reexecs = []
    monkeypatch.setattr(device_guard, "check", unhealthy)
    monkeypatch.setattr(device_guard, "reexec_with_resume",
                        lambda **kw: reexecs.append(kw))
    trainer = Trainer.__new__(Trainer)
    trainer.cfg = config.ExperimentConfig()
    trainer.logger = type("Log", (), {"log": lambda self, msg: None})()
    trainer.device = torch.device("cpu")
    trainer.mesh = Mesh(2, 1)
    trainer.world = trainer.mesh.world
    with pytest.raises(device_guard.DeviceUnhealthyError):
        trainer._guard_device({"clips_per_sec": 1e5, "loss": 1.0})
    assert reexecs == []
