"""The port's multi-process Trainer: ``cli.train.main`` in 2 gloo
processes on the CPU under a torchrun-style environment
(tests/torch_parallel_ranks.py, job ``trainer``), the counterpart of
tests/test_multihost.py for the reference package:

- data parallelism on one node (configs/smoke.yaml, ``mesh_shape``
  unset: both ranks on 'data', each feeder giving the whole batch);
- sequence parallelism (configs/mediapipe/train_seqpar.yaml at
  ``mesh_shape [1, 2]``, clips of 40 frames padded to 48 by the feeder);
- data parallelism over 2 nodes of one rank each (``LOCAL_WORLD_SIZE=1``:
  each node's feeder gives its shard of the epoch) with a validation
  split that no batch or node count divides.

Each run: the per-epoch losses and the final parameters equal on both
ranks; one checkpoint set, written by rank 0, that restores to those
parameters; every validation clip scored once.  The one-node runs also
match a single-process run fed the same batches (run by rank 0 after
the group is gone): losses within 1e-4 relative and parameters within
1e-4 of scale (sync BN's statistics and the reduced gradients are summed
in another order, over 2 epochs)."""

import os
import pickle

import numpy as np
import pytest
import torch

from shift_gcn_torch.utils import checkpoint as ckpt_lib
from torch_parallel_ranks import free_port, run_ranks
from torch_parallel_helpers import ARGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "smoke.yaml")
SEQPAR = os.path.join(REPO, "configs", "mediapipe", "train_seqpar.yaml")
N_TRAIN, N_VAL = 16, 7


def _write(root, name, n, t, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    data = rng.standard_normal((n, 3, t, 33, 1)).astype(np.float32) * 0.1
    data[:, 0] += labels[:, None, None, None] * 0.3
    paths = {"data_path": os.path.join(root, f"{name}.npy"),
             "label_path": os.path.join(root, f"{name}.pkl")}
    np.save(paths["data_path"], data)
    with open(paths["label_path"], "wb") as f:
        pickle.dump(([f"{name}{i}" for i in range(n)], labels.tolist()), f)
    return paths


def _argv(root, experiment, yaml_path, train, val, *extra):
    return ["--config", yaml_path, "--Experiment_name", experiment,
            "--work_dir", os.path.join(root, "work"),
            "--model_saved_name", os.path.join(root, "save"),
            "--train_feeder_args", repr(train),
            "--test_feeder_args", repr(val), "--model_args", repr(ARGS),
            "--batch_size", "4", "--test_batch_size", "4",
            "--num_epoch", "2", "--save_interval", "1",
            "--eval_interval", "1", "--log_interval", "1",
            "--base_lr", "0.05", "--torch-device", "cpu", *extra]


ONE_NODE = ("dp", "seqpar")
RUNS = {"dp": (SMOKE, ()),
        "seqpar": (SEQPAR, ("--mesh_shape", "1", "2",
                            "--activation_dtype", "float32")),
        "two_nodes": (SMOKE, ())}


@pytest.fixture(scope="module")
def trainer_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer"))
    pad = {"pad_to_frames": 48}
    train = _write(root, "train", N_TRAIN, 40, 0)
    val = _write(root, "val", N_VAL, 40, 1)
    argvs = {}
    for name, (yaml_path, extra) in RUNS.items():
        feeders = ({**train, **pad}, {**val, **pad}) if name == "seqpar" \
            else (train, val)
        argvs[name] = _argv(root, name, yaml_path, *feeders, *extra)
    runs = [{"argv": argvs[name],
             "env": {"MASTER_PORT": str(free_port()),
                     "LOCAL_WORLD_SIZE": "1" if name == "two_nodes"
                     else "2"}} for name in RUNS]
    single = [_single_process_argv(argvs[name], root) for name in ONE_NODE]
    outs = run_ranks("trainer", root, 2, {"runs": runs, "single": single})
    results = {name: [o[i] for o in outs] for i, name in enumerate(RUNS)}
    results.update({f"single_{name}": outs[0][len(RUNS) + i]
                    for i, name in enumerate(ONE_NODE)})
    return root, results


def _single_process_argv(argv, root):
    """The same run's config in one process, in directories of its own
    (the rank job clears the mesh)."""
    argv = list(argv)
    argv[argv.index("--work_dir") + 1] = os.path.join(root, "single")
    argv[argv.index("--model_saved_name") + 1] = os.path.join(root, "ssave")
    i = argv.index("--torch-device")
    return argv[:i] + argv[i + 2:]


def _check_run(root, name, ranks, mesh):
    r0, r1 = ranks
    assert r0["mesh"] == r1["mesh"] == mesh
    assert r0["losses"] == r1["losses"]
    assert len(r0["losses"]) == 2 and all(len(e) == 4 // mesh[2]
                                          for e in r0["losses"])
    for key, value in r0["state"].items():
        np.testing.assert_array_equal(r1["state"][key], value, err_msg=key)
    save_dir = os.path.join(root, "save", name)
    assert sorted(os.listdir(save_dir)) == sorted(
        f"{name}-{e}-{s}.pt" for e, s in ((0, 4 // mesh[2]),
                                          (1, 8 // mesh[2])))
    restored = torch.load(ckpt_lib.latest_checkpoint(save_dir),
                          weights_only=True)["model_state_dict"]
    for key, value in r0["state"].items():
        np.testing.assert_array_equal(restored[key].numpy(), value,
                                      err_msg=key)
    with open(os.path.join(root, "work", name, "eval_results",
                           "best_acc.pkl"), "rb") as f:
        best = pickle.load(f)
    assert sorted(best) == sorted(f"val{i}" for i in range(N_VAL))
    return best


@pytest.mark.parametrize("name", ONE_NODE)
def test_one_node_run_matches_single_process(trainer_run, name):
    root, results = trainer_run
    mesh = (2, 1, 1) if name == "dp" else (1, 2, 1)
    best = _check_run(root, name, results[name], mesh)
    single = results[f"single_{name}"]
    assert single["mesh"] is None
    np.testing.assert_allclose(results[name][0]["losses"], single["losses"],
                               rtol=1e-4)
    for key, want in single["state"].items():
        np.testing.assert_allclose(
            results[name][0]["state"][key], want, rtol=0,
            atol=1e-4 * max(1.0, float(np.abs(want).max())), err_msg=key)
    with open(os.path.join(root, "single", name, "eval_results",
                           "best_acc.pkl"), "rb") as f:
        single_best = pickle.load(f)
    for clip, score in single_best.items():
        np.testing.assert_allclose(best[clip], score, rtol=0, atol=1e-4)


def test_two_node_run_shards_the_epoch(trainer_run):
    root, results = trainer_run
    _check_run(root, "two_nodes", results["two_nodes"], (2, 1, 2))
