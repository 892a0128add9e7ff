"""Four-stream training in the port (shift_gcn_torch.train.fourstream and
the Trainer's four-stream branch) against the reference package's
train/fourstream.py on the CPU, with the Pallas kernels in interpret
mode: the on-device derivation, one train step and one eval step on the
same four weight sets; the port's step against four single-stream
steps; the Trainer end to end (pickles, checkpoint, weights, resume,
serving); and the prefetch thread against a serial epoch."""

import dataclasses
import importlib
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_tpu.ops.lowering import Lowering
from shift_gcn_tpu.train import fourstream as jax_fs
from shift_gcn_tpu.train import state as jax_state
from shift_gcn_tpu.train.optim import build_weight_decay_tree
from shift_gcn_torch.cli import train as cli_train
from shift_gcn_torch.data.modalities import derive_modalities
from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.inference.pipeline import EnsemblePredictor
from shift_gcn_torch.models.shift_gcn import Model, config_from_reference_args
from shift_gcn_torch.train import config, fourstream, optim, state
from shift_gcn_torch.train.trainer import Trainer
from shift_gcn_torch.utils import checkpoint as ckpt_lib

tsk = importlib.import_module(
    "shift_gcn_tpu.ops.pallas.temporal_shift_kernel")
sgk = importlib.import_module("shift_gcn_tpu.ops.pallas.shift_gcn_kernel")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOURSTREAM_CONFIG = os.path.join(REPO, "configs", "mediapipe",
                                 "train_fourstream.yaml")
# 2 units: a down conv (3->8, no residual) and a stride-2 unit with a
# residual conv (8->16); V=33, T=16
ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
        "graph": "mediapipe_pose",
        "blocks": [[3, 8, 1, False], [8, 16, 2]]}
PARENTS = get_graph("mediapipe_pose").bone_parents()


@pytest.fixture(scope="module", autouse=True)
def no_onednn():
    # as in test_torch_train.py: torch's oneDNN convolution backward
    # corrupts the heap on the CPU once the reference package's compiled
    # XLA code has run in the same process
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = saved


@pytest.fixture(scope="module")
def interpret():
    saved = tsk._INTERPRET, sgk._INTERPRET
    tsk._INTERPRET = sgk._INTERPRET = True
    yield
    tsk._INTERPRET, sgk._INTERPRET = saved


def _jax_config():
    return dataclasses.replace(
        jax_model.config_from_reference_args(ARGS), use_pallas=True,
        lowering=Lowering(tshift_impl="pallas"))


def _batch(seed, n=4, t=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, t, 33, 1)).astype(np.float32),
            rng.integers(0, 2, n).astype(np.int32))


def _flat(tree):
    """Reference parameter tree -> {port parameter name: array}."""
    return {k: v.numpy() for k, v in
            ckpt_lib.state_dict_from_arrays(tree, {}).items()
            if not k.endswith(("shift_in", "shift_out"))}


def _reference_state4(seed):
    state4 = jax_fs.create_fourstream_state(jax.random.key(seed),
                                            _jax_config())
    params4 = jax.tree_util.tree_map(np.asarray, state4.params)
    bn4 = jax.tree_util.tree_map(np.asarray, state4.bn_state)
    return state4, ckpt_lib.stream_state_dicts_from_arrays(
        params4, bn4, fourstream.STREAMS)


def _port_models(state_dicts):
    cfg = config_from_reference_args(ARGS)
    models = {}
    for stream in fourstream.STREAMS:
        models[stream] = Model(cfg, device="cpu")
        models[stream].load_state_dict(state_dicts[stream])
    return models


def test_derive_modalities_device_matches_reference():
    joint, _ = _batch(0, n=3)
    got = fourstream.derive_modalities_device(torch.from_numpy(joint),
                                              PARENTS)
    want = np.asarray(jax_fs.derive_modalities_device(jnp.asarray(joint),
                                                      PARENTS))
    assert got.shape == (4,) + joint.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # and the offline generators' streams, in STREAMS order
    mods = derive_modalities(joint, get_graph("mediapipe_pose"))
    for i, stream in enumerate(fourstream.STREAMS):
        np.testing.assert_array_equal(got[i].numpy(), mods[stream])
    assert fourstream.STREAMS == jax_fs.STREAMS
    assert fourstream.ENSEMBLE_ALPHAS == jax_fs.ENSEMBLE_ALPHAS


def test_train_step_matches_reference(interpret):
    """One four-stream step on the same four weight sets: per-stream loss
    at fp32 roundoff, true gradients at roundoff with the ypos constraint
    steps bit-equal, and the parameters and BN statistics after SGD
    within the North star's tolerances."""
    cfg = _jax_config()
    state4, state_dicts = _reference_state4(0)
    joint, label = _batch(1)
    lr = 0.1
    wd = build_weight_decay_tree(jax.tree_util.tree_map(
        lambda x: x[0], state4.params))
    step4 = jax.jit(jax_fs.make_fourstream_train_step(
        cfg, wd, jax_fs.graph_for_config(cfg)))
    new4, metrics = step4(state4, {"data": jnp.asarray(joint),
                                   "label": jnp.asarray(label)},
                          jnp.float32(lr))

    def loss_fn(p, s, data):
        logits, new_s = jax_model.apply(p, s, data, cfg, training=True)
        return jax_state.cross_entropy(logits, jnp.asarray(label)), new_s

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    data4 = jax_fs.derive_modalities_device(jnp.asarray(joint), PARENTS)

    models = _port_models(state_dicts)
    opts = {s: optim.build_optimizer(m, lr) for s, m in models.items()}
    losses, accs = fourstream.train_step(
        models, opts, {"data": torch.from_numpy(joint),
                       "label": torch.from_numpy(label).long()}, lr, PARENTS)
    assert losses.shape == accs.shape == (4,)
    ref_losses = np.asarray(metrics["loss"])
    for i, stream in enumerate(fourstream.STREAMS):
        assert abs(float(losses[i]) - float(ref_losses[i])) <= 1e-5 * max(
            1.0, abs(float(ref_losses[i]))), stream
        pick = (lambda x, i=i: x[i])
        (_, _), grads = grad_fn(jax.tree_util.tree_map(pick, state4.params),
                                jax.tree_util.tree_map(pick,
                                                       state4.bn_state),
                                data4[i])
        ref_g = _flat(jax.tree_util.tree_map(np.asarray, grads))
        got_g = {n: p.grad.numpy()
                 for n, p in models[stream].named_parameters()}
        assert set(ref_g) == set(got_g)
        for name, want in ref_g.items():
            if name.endswith("xpos"):
                assert not got_g[name].any(), name
            elif name.endswith("ypos"):
                np.testing.assert_array_equal(got_g[name], want,
                                              err_msg=f"{stream} {name}")
            else:
                tol = 1e-5 + 2e-4 * float(np.abs(want).max())
                np.testing.assert_allclose(got_g[name], want, rtol=0,
                                           atol=tol,
                                           err_msg=f"{stream} {name}")
        sd = {k: v.numpy() for k, v in models[stream].state_dict().items()}
        new_params = _flat(jax.tree_util.tree_map(
            lambda x, i=i: np.asarray(x[i]), new4.params))
        for name, want in new_params.items():
            tol = 1e-6 + 0.19 * (1e-5 + 2e-4 * float(
                np.abs(ref_g[name]).max()))
            np.testing.assert_allclose(sd[name], want, rtol=0, atol=tol,
                                       err_msg=f"{stream} {name}")
        stats = ckpt_lib.state_dict_from_arrays({}, jax.tree_util.tree_map(
            lambda x, i=i: np.asarray(x[i]), new4.bn_state))
        for name, want in stats.items():
            np.testing.assert_allclose(sd[name], want.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{stream} {name}")


def test_eval_step_matches_reference(interpret):
    cfg = _jax_config()
    state4, state_dicts = _reference_state4(2)
    joint, label = _batch(3, n=5)
    mask = np.array([1, 1, 1, 0, 1], np.float32)
    eval4 = jax.jit(jax_fs.make_fourstream_eval_step(
        cfg, jax_fs.graph_for_config(cfg)))
    want = eval4(state4.params, state4.bn_state,
                 {"data": jnp.asarray(joint), "label": jnp.asarray(label),
                  "mask": jnp.asarray(mask)})
    got = fourstream.eval_step(
        _port_models(state_dicts),
        {"data": torch.from_numpy(joint),
         "label": torch.from_numpy(label).long(),
         "mask": torch.from_numpy(mask)}, PARENTS)
    for name, g, w in zip(("logits4", "ensemble", "loss_sums", "ns"), got,
                          want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()),
                                   err_msg=name)
    ensemble = sum(a * logits for a, logits in
                   zip(fourstream.ENSEMBLE_ALPHAS, got[0].numpy()))
    np.testing.assert_allclose(got[1].numpy(), ensemble, rtol=0, atol=1e-6)


def test_step_is_four_single_stream_steps():
    """On the CPU the four-stream step is bit-equal to four single-stream
    steps over the offline generators' streams, from the same weights;
    and create_models gives the joint stream a single-stream run's
    initialization at the same seed."""
    cfg = dataclasses.replace(config_from_reference_args(ARGS),
                              activation_dtype="bfloat16")
    models = fourstream.create_models(cfg, 7, device="cpu")
    single = Model(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(7))
    for k, v in single.state_dict().items():
        assert torch.equal(models["joint"].state_dict()[k], v), k
    assert not torch.equal(models["joint"].l1.gcn1.Linear_weight,
                           models["bone"].l1.gcn1.Linear_weight)
    copies = {s: Model(cfg, device="cpu") for s in fourstream.STREAMS}
    for s, m in copies.items():
        m.load_state_dict(models[s].state_dict())
    opts = {s: optim.build_optimizer(m, 0.1) for s, m in models.items()}
    copy_opts = {s: optim.build_optimizer(m, 0.1) for s, m in copies.items()}
    for seed, lr in ((4, 0.1), (5, 0.05)):
        joint, label = _batch(seed)
        y = torch.from_numpy(label).long()
        losses, _ = fourstream.train_step(
            models, opts, {"data": torch.from_numpy(joint), "label": y}, lr,
            PARENTS)
        mods = derive_modalities(joint, get_graph("mediapipe_pose"))
        for i, stream in enumerate(fourstream.STREAMS):
            loss, _ = state.train_step(
                copies[stream], copy_opts[stream],
                {"data": torch.from_numpy(np.ascontiguousarray(
                    mods[stream])), "label": y}, lr)
            assert torch.equal(losses[i], loss), stream
    for stream in fourstream.STREAMS:
        want = copies[stream].state_dict()
        for k, v in models[stream].state_dict().items():
            assert torch.equal(v, want[k]), f"{stream} {k}"


def _write_dataset(root, n, t, seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    data = rng.standard_normal((n, 3, t, 33, 1)).astype(np.float32) * 0.1
    data[:, 0] += labels[:, None, None, None] * 0.3  # two-class signal
    np.save(os.path.join(root, "data.npy"), data)
    with open(os.path.join(root, "label.pkl"), "wb") as f:
        pickle.dump(([f"clip{i}" for i in range(n)], labels.tolist()), f)
    return {"data_path": os.path.join(root, "data.npy"),
            "label_path": os.path.join(root, "label.pkl")}


def _argv(tmp_path, paths, *extra):
    return ["--config", FOURSTREAM_CONFIG,
            "--work_dir", str(tmp_path / "work"),
            "--model_saved_name", str(tmp_path / "save"),
            "--train_feeder_args", repr(paths),
            "--test_feeder_args", repr(paths), "--model_args", repr(ARGS),
            "--batch_size", "4", "--test_batch_size", "5",
            "--num_epoch", "1", "--save_interval", "1",
            "--eval_interval", "1", "--log_interval", "1", *extra]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_trainer_end_to_end(tmp_path):
    """The CLI on configs/mediapipe/train_fourstream.yaml (its model cut to
    2 units): native loader, per-stream and ensemble pickles, one
    four-stream checkpoint that serves and resumes, weights from it in
    the test phase."""
    paths = _write_dataset(str(tmp_path), 12, 16, 0)
    argv = _argv(tmp_path, paths, "--native_loader", "true")
    best = cli_train.main(argv + ["--torch-device", "cpu"])
    assert 0.0 <= best <= 1.0
    eval_dir = tmp_path / "work" / "mediapipe_ShiftGCN_fourstream" / \
        "eval_results"
    save_dir = tmp_path / "save" / "mediapipe_ShiftGCN_fourstream"
    assert os.listdir(save_dir) == ["mediapipe_ShiftGCN_fourstream-0-3.pt"]
    files = set(os.listdir(eval_dir))
    for stream in fourstream.STREAMS:
        assert {f"best_acc_{stream}.pkl", f"epoch_0_{stream}.pkl"} <= files
    assert "best_acc.pkl" in files
    assert len([f for f in files if f.startswith("epoch_0_0")]) == 1
    names = [f"clip{i}" for i in range(12)]
    ens = _load(eval_dir / "best_acc.pkl")
    streams = {s: _load(eval_dir / f"best_acc_{s}.pkl")
               for s in fourstream.STREAMS}
    assert list(ens) == names
    for name in names:
        want = sum(a * streams[s][name] for a, s in
                   zip(fourstream.ENSEMBLE_ALPHAS, fourstream.STREAMS))
        np.testing.assert_allclose(ens[name], want, rtol=0, atol=1e-6)

    # the checkpoint serves: each stream's model reproduces its pickle
    cfg = dataclasses.replace(config_from_reference_args(ARGS),
                              activation_dtype="bfloat16")
    predictor = EnsemblePredictor.from_fourstream_checkpoint(
        str(save_dir), model_config=cfg, device="cpu")
    data = np.load(paths["data_path"])
    x = torch.from_numpy(data).to(torch.bfloat16).float()
    derived = fourstream.derive_modalities_device(x, PARENTS)
    with torch.no_grad():
        for i, stream in enumerate(fourstream.STREAMS):
            got = predictor._models[stream](derived[i]).numpy()
            want = np.stack([streams[stream][n] for n in names])
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=stream)
    probs = predictor.predict(data[:2])
    assert probs.shape == (2, 2)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-6)

    # resume continues at the next epoch with the saved step count
    trainer = Trainer(config.load_config(
        _argv(tmp_path, paths, "--resume", "auto", "--num_epoch", "2")),
        device="cpu")
    assert (trainer.start_epoch, trainer.global_step) == (1, 3)
    trainer.start()
    assert "mediapipe_ShiftGCN_fourstream-1-6.pt" in os.listdir(save_dir)
    _, meta = ckpt_lib.load_fourstream_checkpoint(
        ckpt_lib.latest_checkpoint(str(save_dir)))
    assert (meta["epoch"], meta["global_step"]) == (1, 6)

    # the test phase takes the checkpoint as weights; wrong/right files
    # hold the ensemble's predictions
    ckpt = ckpt_lib.latest_checkpoint(str(save_dir))
    tester = Trainer(config.load_config(_argv(
        tmp_path / "test", paths, "--phase", "test", "--weights", ckpt)),
        device="cpu")
    acc = tester.start()
    work = tmp_path / "test" / "work" / "mediapipe_ShiftGCN_fourstream"
    right = (work / "right.txt").read_text().split()
    assert len(right) == 12
    labels = _load(paths["label_path"])[1]
    hits = sum(int(r.split(",")[0]) == labels[i] for i, r in enumerate(right))
    assert acc == pytest.approx(hits / 12)
    assert len((work / "wrong.txt").read_text().split()) == 12 - hits


def test_weights_take_a_fourstream_checkpoint(tmp_path):
    paths = _write_dataset(str(tmp_path), 8, 16, 1)
    cfg = config.load_config(_argv(tmp_path, paths))
    source = Trainer(cfg, device="cpu")
    four = source.save(0)
    single = ckpt_lib.save_checkpoint(
        str(tmp_path), "single", 0, 0, 0.0, source.models["joint"],
        source.optimizers["joint"])

    for path in (single, str(tmp_path / "scores.pkl")):
        with pytest.raises(ValueError, match="four-stream checkpoint"):
            Trainer(dataclasses.replace(cfg, weights=path, seed=2),
                    device="cpu")
    # and a single-stream run refuses the four-stream file
    with pytest.raises(ValueError, match="is a four-stream checkpoint"):
        Trainer(dataclasses.replace(cfg, fourstream=False, weights=four),
                device="cpu")

    loaded = Trainer(dataclasses.replace(cfg, weights=four, seed=2,
                                         ignore_weights=["fc."]),
                     device="cpu")
    fresh = fourstream.create_models(loaded.model_config, 2, device="cpu")
    for stream in fourstream.STREAMS:
        want = source.models[stream].state_dict()
        for k, v in loaded.models[stream].state_dict().items():
            expect = fresh[stream].state_dict()[k] if k.startswith(
                "fc.") else want[k]
            assert torch.equal(v, expect), f"{stream} {k}"


@pytest.mark.parametrize("four", [False, True], ids=["single", "fourstream"])
def test_prefetch_epoch_equals_serial_epoch(tmp_path, four):
    """The prefetch thread changes nothing: an epoch's losses and the
    weights after it are bit-equal to a serial loop over the same
    batches, with the bf16 transfer rounding."""
    paths = _write_dataset(str(tmp_path), 16, 16, 2)
    argv = _argv(tmp_path, paths, "--fourstream", str(four).lower())
    trainer = Trainer(config.load_config(argv), device="cpu")
    models = (trainer.models if four else {"joint": trainer.model})
    start = {s: {k: v.clone() for k, v in m.state_dict().items()}
             for s, m in models.items()}
    stats = trainer.train_epoch(0)
    after = {s: {k: v.clone() for k, v in m.state_dict().items()}
             for s, m in models.items()}
    assert len(stats["losses"]) == 4
    assert np.isfinite(stats["losses"]).all()
    assert 0.0 < stats["dataloader_share"] < 1.0

    for s, m in models.items():
        m.load_state_dict(start[s])
    if four:
        trainer.optimizers = {s: optim.build_optimizer(m, 0.1)
                              for s, m in models.items()}
    else:
        trainer.optimizer = optim.build_optimizer(trainer.model, 0.1)
    serial = []
    for data, label, _, _ in trainer.iterators["train"].epoch(0):
        loss, _ = trainer._train_step(trainer._put_batch(data, label), 0.1)
        serial.append(loss.numpy())
    serial = np.stack(serial)
    want = serial.mean(-1) if four else serial
    assert stats["losses"] == want.tolist()
    if four:
        assert stats["stream_losses"] == serial.tolist()
    for s, m in models.items():
        for k, v in m.state_dict().items():
            assert torch.equal(v, after[s][k]), f"{s} {k}"


def test_prefetch_thread_errors_reach_the_step(tmp_path, monkeypatch):
    paths = _write_dataset(str(tmp_path), 8, 16, 3)
    trainer = Trainer(config.load_config(_argv(tmp_path, paths)),
                      device="cpu")

    def broken(*args, **kwargs):
        raise OSError("copy failed")

    monkeypatch.setattr(trainer.transfer, "stage", broken)
    with pytest.raises(OSError, match="copy failed"):
        trainer.train_epoch(0)
