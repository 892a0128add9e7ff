"""The port's tensor-parallel Trainer: ``cli.train.main`` at
``mesh_shape [1, 2]`` in 2 gloo processes on the CPU
(tests/torch_parallel_ranks.py, job ``trainer``), beside one-process
runs of the same config made by rank 0 before and after the group:

- the [1, 2] run trains 2 epochs, evaluates each and writes full-layout
  checkpoints (rank 0, the slices gathered); its losses and final
  parameters match the one-process run's within 1e-4 (sync BN and the
  reduced gradients sum in another order, over 2 epochs), and each rank
  holds its slices;
- its last checkpoint loads in one process (``phase: test``) and scores
  every validation clip as the [1, 2] run's last evaluation did;
- the one-process run's first checkpoint resumes under [1, 2] and ends
  where the one-process run did.

``check_supported``'s side (TP taken, an edge partition without model
ranks refused, an uneven width refused) is in test_torch_parallel_launch.py and
test_torch_registry.py."""

import os
import pickle

import numpy as np
import pytest
import torch

from torch_parallel_ranks import free_port, run_ranks
from test_torch_parallel_trainer import N_VAL, SMOKE, _argv, _write


SHARDED = ("Linear_weight", "temporal_linear.weight")


def _dirs(argv, root, tag):
    """``argv`` with work and save directories of its own."""
    argv = list(argv)
    argv[argv.index("--work_dir") + 1] = os.path.join(root, f"{tag}_work")
    argv[argv.index("--model_saved_name") + 1] = os.path.join(
        root, f"{tag}_save")
    return argv


def _one_process(argv, root, tag):
    """``argv`` in one process (the rank job runs it on the CPU), in
    directories of its own."""
    argv = _dirs(argv, root, tag)
    i = argv.index("--torch-device")
    return argv[:i] + argv[i + 2:]


def _checkpoint(root, save, name, epoch):
    path = os.path.join(root, save, name, f"{name}-{epoch}-{4 * (epoch + 1)}"
                        ".pt")
    return torch.load(path, weights_only=True)


def _scores(root, work, name, pattern):
    found = [f for f in os.listdir(os.path.join(root, work, name,
                                                "eval_results"))
             if f.startswith(pattern)]
    assert len(found) == 1, found
    with open(os.path.join(root, work, name, "eval_results", found[0]),
              "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def tp_trainer_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_trainer"))
    train = _write(root, "train", 16, 40, 0)
    val = _write(root, "val", N_VAL, 40, 1)
    tp = _argv(root, "tp", SMOKE, train, val, "--mesh_shape", "1", "2")
    single = _one_process(tp, root, "single")
    resumed = _dirs(tp, root, "resumed") + [
        "--resume", os.path.join(root, "single_save", "tp", "tp-0-4.pt")]
    test = _one_process(tp, root, "test") + [
        "--phase", "test", "--weights",
        os.path.join(root, "save", "tp", "tp-1-8.pt")]
    runs = [{"argv": argv, "env": {"MASTER_PORT": str(free_port()),
                                   "LOCAL_WORLD_SIZE": "2"}}
            for argv in (tp, resumed)]
    outs = run_ranks("trainer", root, 2, {"before": [single], "runs": runs,
                                           "single": [test]})
    return root, outs


def test_tp_run_matches_one_process_and_saves_full_layout(tp_trainer_run):
    root, outs = tp_trainer_run
    single, tp0 = outs[0][0], outs[0][1]
    tp1 = outs[1][0]
    assert single["mesh"] is None
    assert tp0["mesh"] == tp1["mesh"] == (1, 2, 1)
    assert tp0["losses"] == tp1["losses"]
    np.testing.assert_allclose(tp0["losses"], single["losses"], rtol=1e-4)
    assert tp0["state"]["l1.gcn1.Linear_weight"].shape == (3, 4)
    assert tp0["state"]["l2.tcn1.temporal_linear.weight"].shape == (
        8, 16, 1, 1)
    # the checkpoint: the replicated entries as on each rank, the sharded
    # ones the ranks' slices side by side
    saved = _checkpoint(root, "save", "tp", 1)
    want = _checkpoint(root, "single_save", "tp", 1)
    for key, value in want["model_state_dict"].items():
        got = saved["model_state_dict"][key].numpy()
        assert got.shape == tuple(value.shape), key
        if key.endswith(SHARDED):
            axis = 1 if key.endswith("Linear_weight") else 0
            np.testing.assert_array_equal(got, np.concatenate(
                [tp0["state"][key], tp1["state"][key]], axis), err_msg=key)
        else:
            np.testing.assert_array_equal(got, tp0["state"][key],
                                          err_msg=key)
            np.testing.assert_array_equal(got, tp1["state"][key],
                                          err_msg=key)
        np.testing.assert_allclose(
            got, value.numpy(), rtol=0,
            atol=1e-4 * max(1.0, float(value.abs().max())), err_msg=key)
    # the momentum in the full layout too
    for index, entry in want["optimizer_state_dict"]["state"].items():
        got = saved["optimizer_state_dict"]["state"][index][
            "momentum_buffer"]
        assert got.shape == entry["momentum_buffer"].shape, index


def test_tp_checkpoint_scores_alike_in_one_process(tp_trainer_run):
    root, outs = tp_trainer_run
    tp_scores = _scores(root, "work", "tp", "epoch_1_")
    one = _scores(root, "test_work", "tp", "epoch_0_")
    assert sorted(one) == sorted(tp_scores) == sorted(
        f"val{i}" for i in range(N_VAL))
    for clip, score in one.items():
        np.testing.assert_allclose(score, tp_scores[clip], rtol=0,
                                   atol=1e-5)


def test_one_process_checkpoint_resumes_under_tp(tp_trainer_run):
    root, outs = tp_trainer_run
    single, resumed = outs[0][0], outs[0][2]
    assert resumed["mesh"] == (1, 2, 1)
    # epoch 1 only: resumed from the one-process run's epoch 0
    assert len(resumed["losses"]) == 1
    np.testing.assert_allclose(resumed["losses"][0], single["losses"][1],
                               rtol=1e-4)
    got = _checkpoint(root, "resumed_save", "tp", 1)["model_state_dict"]
    want = _checkpoint(root, "single_save", "tp", 1)["model_state_dict"]
    for key, value in want.items():
        np.testing.assert_allclose(
            got[key].numpy(), value.numpy(), rtol=0,
            atol=1e-4 * max(1.0, float(value.abs().max())), err_msg=key)
