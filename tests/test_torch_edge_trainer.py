"""The port's edge-partitioned Trainer: ``cli.train.main`` from the shipped
``configs/stgcn_edges.yaml`` (``gather``) and ``configs/synthetic_ring.yaml``
(``ring``) in 4 gloo processes on the CPU (tests/torch_parallel_ranks.py,
job ``trainer``), their meshes cut to 4 ranks ([2, 4] -> [2, 2], [1, 8]
-> [1, 4]) and ST-GCN narrowed to 2 blocks, beside one-process runs of
the same configs made by rank 0 before the group:

- each run trains its epochs and evaluates; every rank ends with the
  same parameters, and the losses and parameters match the one-process
  run's within 1e-4 (BN's statistics and the gradients are summed in
  another order, over several steps);
- rank 0 writes the checkpoint in the reference layout: it holds the
  ranks' (replicated) parameters, and evaluated in one process
  (``phase: test``, the edge-partition keys off) it scores every
  validation clip as the run's last evaluation did.

The refusals and the steps against the reference package are in
test_torch_edge_partition.py."""

import os
import pickle

import numpy as np
import pytest
import torch

from torch_parallel_ranks import free_port, run_ranks
from test_torch_parallel_trainer import _write

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STGCN_ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
              "graph": "mediapipe_pose", "channels": [8, 16],
              "strides": [1, 2]}
N_VAL = 8
# name -> (config, mesh cut to 4 ranks, extra flags, epochs, steps an
# epoch); synthetic_ring.yaml's model and batch (16) are kept
RUNS = {
    "stgcn_edges": ("stgcn_edges.yaml", ("2", "2"), (
        "--model_args", repr(STGCN_ARGS), "--batch_size", "4",
        "--test_batch_size", "4"), 2, 4),
    "synthetic_ring": ("synthetic_ring.yaml", ("1", "4"), (), 3, 2),
}


def _write_ring(root, name, n, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    data = rng.standard_normal((n, 8, 1, 256, 1)).astype(np.float32)
    data[:, 0] += (labels * 1.5 - 0.75)[:, None, None, None]
    paths = {"data_path": os.path.join(root, f"{name}.npy"),
             "label_path": os.path.join(root, f"{name}.pkl")}
    np.save(paths["data_path"], data)
    with open(paths["label_path"], "wb") as f:
        pickle.dump(([f"{name}{i}" for i in range(n)], labels.tolist()), f)
    return paths


def _argv(root, name, tag, train, val):
    config, _, extra, _, _ = RUNS[name]
    return ["--config", os.path.join(REPO, "configs", config),
            "--work_dir", os.path.join(root, f"{tag}_work"),
            "--model_saved_name", os.path.join(root, f"{tag}_save"),
            "--train_feeder_args", repr(train),
            "--test_feeder_args", repr(val), "--log_interval", "1",
            "--torch-device", "cpu", *extra]


def _one_process(argv):
    """``argv`` for rank 0 alone: the edge partition off (the rank job
    clears the mesh), without the device flag (it runs on the CPU)."""
    i = argv.index("--torch-device")
    return argv[:i] + argv[i + 2:] + ["--edge_partition", "false"]


@pytest.fixture(scope="module")
def edge_trainer_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("edge_trainer"))
    splits = {"stgcn_edges": (_write(root, "train", 16, 16, 0),
                              _write(root, "val", N_VAL, 16, 1)),
              "synthetic_ring": (_write_ring(root, "ring_train", 32, 2),
                                 _write_ring(root, "ring_val", N_VAL, 3))}
    before, runs, single = [], [], []
    for name, (_, mesh, _, epochs, steps) in RUNS.items():
        argv = _argv(root, name, "run", *splits[name])
        before.append(_one_process(_argv(root, name, "one",
                                         *splits[name])))
        runs.append({"argv": argv + ["--mesh_shape", *mesh],
                     "env": {"MASTER_PORT": str(free_port()),
                             "LOCAL_WORLD_SIZE": "4"}})
        last = f"{name}-{epochs - 1}-{epochs * steps}.pt"
        single.append(_one_process(_argv(root, name, "test", *splits[
            name])) + ["--phase", "test", "--weights",
                       os.path.join(root, "run_save", name, last)])
    outs = run_ranks("trainer", root, 4, {"before": before, "runs": runs,
                                           "single": single}, timeout=400)
    return root, outs


def _scores(root, tag, name, pattern):
    folder = os.path.join(root, f"{tag}_work", name, "eval_results")
    found = sorted(f for f in os.listdir(folder) if f.startswith(pattern))
    with open(os.path.join(folder, found[-1]), "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("index,name", list(enumerate(RUNS)),
                         ids=list(RUNS))
def test_run_matches_one_process_on_every_rank(edge_trainer_run, index,
                                               name):
    root, outs = edge_trainer_run
    _, mesh, _, epochs, steps = RUNS[name]
    one = outs[0][index]
    assert one["mesh"] is None
    runs = [out[len(RUNS) + index] if rank == 0 else out[index]
            for rank, out in enumerate(outs)]
    for run in runs:
        assert run["mesh"] == (int(mesh[0]), int(mesh[1]), 1)
        assert [len(e) for e in run["losses"]] == [steps] * epochs
        assert run["losses"] == runs[0]["losses"]
        for key, value in runs[0]["state"].items():
            np.testing.assert_array_equal(run["state"][key], value,
                                          err_msg=key)
    np.testing.assert_allclose(runs[0]["losses"], one["losses"], rtol=1e-4)
    for key, value in one["state"].items():
        np.testing.assert_allclose(
            runs[0]["state"][key], value, rtol=0,
            atol=1e-4 * max(1.0, float(np.abs(value).max())), err_msg=key)


@pytest.mark.parametrize("index,name", list(enumerate(RUNS)),
                         ids=list(RUNS))
def test_checkpoint_scores_alike_in_one_process(edge_trainer_run, index,
                                                name):
    root, outs = edge_trainer_run
    _, _, _, epochs, steps = RUNS[name]
    saved = torch.load(os.path.join(
        root, "run_save", name, f"{name}-{epochs - 1}-{epochs * steps}.pt"),
        weights_only=True)["model_state_dict"]
    state = outs[1][index]["state"]
    assert set(saved) == set(state)
    for key, value in saved.items():
        np.testing.assert_array_equal(value.numpy(), state[key],
                                      err_msg=key)
    got = _scores(root, "run", name, f"epoch_{epochs - 1}_")
    one = _scores(root, "test", name, "epoch_0_")
    assert sorted(one) == sorted(got) == sorted(
        f"{'ring_' if 'ring' in name else ''}val{i}" for i in range(N_VAL))
    for clip, score in one.items():
        np.testing.assert_allclose(score, got[clip], rtol=0, atol=1e-5)
