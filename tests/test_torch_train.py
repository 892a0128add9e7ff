"""Port training (shift_gcn_torch.train) vs the reference package on the
CPU: one and three train steps against ``make_train_step`` with the
Pallas kernels in interpret mode, the optimizer table and schedule, the
data pipeline and config parsing, and the Trainer end to end with a
checkpoint the reference package reads back."""

import dataclasses
import glob
import importlib
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shift_gcn_tpu.data import feeder as jax_feeder
from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_tpu.ops.lowering import Lowering
from shift_gcn_tpu.train import config as jax_config
from shift_gcn_tpu.train import state as jax_state
from shift_gcn_tpu.train.optim import (
    build_weight_decay_tree, sgd_update, weight_decay_for_path)
from shift_gcn_tpu.train.optim import step_decay_lr as jax_step_decay_lr
from shift_gcn_tpu.utils.checkpoint import (
    load_reference_checkpoint as jax_load_reference_checkpoint)
from shift_gcn_torch.cli import train as cli_train
from shift_gcn_torch.data import feeder
from shift_gcn_torch.models.shift_gcn import Model, config_from_reference_args
from shift_gcn_torch.train import config, optim, state
from shift_gcn_torch.train.trainer import Trainer
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

tsk = importlib.import_module(
    "shift_gcn_tpu.ops.pallas.temporal_shift_kernel")
sgk = importlib.import_module("shift_gcn_tpu.ops.pallas.shift_gcn_kernel")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 3 units: a down conv (3->8, no residual), a stride-2 unit with a residual
# conv (8->16), an identity residual; V=33
ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
        "graph": "mediapipe_pose",
        "blocks": [[3, 8, 1, False], [8, 16, 2], [16, 16]]}


@pytest.fixture(scope="module", autouse=True)
def no_onednn():
    # torch's oneDNN convolution backward corrupts the heap on the CPU once
    # the reference package's compiled XLA code has run in the same
    # process; torch's native convolution has the same arithmetic
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


def _jax_config(**overrides):
    return dataclasses.replace(
        jax_model.config_from_reference_args(ARGS), use_pallas=True,
        lowering=Lowering(tshift_impl="pallas"), **overrides)


def _batches(count, seed, n=4, t=32):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, 3, t, 33, 1)).astype(np.float32),
             rng.integers(0, 2, n).astype(np.int32)) for _ in range(count)]


def _flat(tree):
    """Reference parameter tree -> {port parameter name: array}."""
    return {k: v.numpy() for k, v in state_dict_from_arrays(tree, {}).items()
            if not k.endswith(("shift_in", "shift_out"))}


def _lockstep(act_dtype, lrs, seed, remat=False):
    """Run the reference step and the port's train_step from the same
    weights on the same batches, both with per-block recomputation when
    ``remat``; yields per step (reference loss, port loss, reference
    grads, port grads, reference state, port model)."""
    cfg = _jax_config(activation_dtype=act_dtype, remat=remat)
    ts = jax_state.create_train_state(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map(np.asarray, ts.params)
    bn_state = jax.tree_util.tree_map(np.asarray, ts.bn_state)
    wd_tree = build_weight_decay_tree(ts.params)

    def loss_fn(p, s, data, label):
        logits, new_s = jax_model.apply(p, s, data, cfg, training=True)
        return jax_state.cross_entropy(logits, label), new_s

    @jax.jit
    def ref_step(ts, data, label, lr):
        (loss, new_bn), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            ts.params, ts.bn_state, data, label)
        new_p, new_opt = sgd_update(ts.params, grads, ts.opt_state, lr,
                                    wd_tree)
        return ts._replace(params=new_p, bn_state=new_bn,
                           opt_state=new_opt), loss, grads

    port_cfg = dataclasses.replace(config_from_reference_args(ARGS),
                                   activation_dtype=act_dtype, remat=remat)
    model = Model(port_cfg, device="cpu")
    model.load_state_dict(state_dict_from_arrays(params, bn_state))
    opt = optim.build_optimizer(model, lrs[0])
    for (data, label), lr in zip(_batches(len(lrs), seed), lrs):
        ts, loss, grads = ref_step(ts, jnp.asarray(data), jnp.asarray(label),
                                   jnp.float32(lr))
        got_loss, _ = state.train_step(
            model, opt, {"data": torch.from_numpy(data),
                         "label": torch.from_numpy(label).long()}, lr)
        port_grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
        yield (float(loss), float(got_loss), _flat(grads), port_grads, ts,
               model)


def _assert_grads(ref, got, true_atol, true_rtol):
    assert set(ref) == set(got)
    for name, want in ref.items():
        if name.endswith("xpos"):
            np.testing.assert_array_equal(got[name], np.zeros_like(want))
        elif name.endswith("ypos"):
            # constraint steps: exactly +-0.01 or 1e-4, bit-equal
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        else:
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(
                got[name], want, rtol=0,
                atol=true_atol + true_rtol * scale, err_msg=name)


def test_one_train_step_matches_reference(interpret):
    ref_loss, loss, ref_g, got_g, ts, model = next(
        _lockstep(None, [0.1], seed=0))
    assert abs(loss - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    # true gradients: fp32 roundoff of another summation order
    _assert_grads(ref_g, got_g, 1e-5, 2e-4)
    # after SGD, params and BN running stats: the gradients' roundoff
    # times lr * (1 + momentum), plus fp32 roundoff
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    new_params = _flat(jax.tree_util.tree_map(np.asarray, ts.params))
    for name, want in new_params.items():
        tol = 1e-6 + 0.19 * (1e-5 + 2e-4 * float(np.abs(ref_g[name]).max()))
        np.testing.assert_allclose(sd[name], want, rtol=0, atol=tol,
                                   err_msg=name)
    stats = state_dict_from_arrays({}, jax.tree_util.tree_map(
        np.asarray, ts.bn_state))
    for name, want in stats.items():
        np.testing.assert_allclose(sd[name], want.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_three_steps_in_lockstep(interpret):
    # step_decay_lr with a 2-epoch warmup then a decay: 0.05, 0.1, 0.01
    lrs = [optim.step_decay_lr(e, 0.1, [2], warm_up_epoch=2)
           for e in range(3)]
    assert lrs == pytest.approx([0.05, 0.1, 0.01])
    for ref_loss, loss, ref_g, got_g, _, _ in _lockstep(None, lrs, seed=1):
        # states drift apart by roundoff step by step; the position steps
        # stay bit-equal (no dither tie in 3 steps from this seed)
        assert abs(loss - ref_loss) <= 1e-4 * max(1.0, abs(ref_loss))
        _assert_grads(ref_g, got_g, 1e-4, 1e-3)


def test_bf16_step_within_envelope(interpret):
    # bf16 activations on both sides: 8-bit mantissas through 3 units and
    # their backward, rounded at different places by the two frameworks.
    # Measured over seeds 2-4: loss within 0.25%, the concatenated true
    # gradient at cosine 0.992-0.996 and 8.5-12.4% relative L2 gap (the
    # biases that feed a batch-statistics BN have a zero exact gradient
    # and carry only rounding noise), ypos steps equal on 78-80 of 80
    # channels.  The envelope below is about twice those gaps.
    ref_loss, loss, ref_g, got_g, _, _ = next(
        _lockstep("bfloat16", [0.1], seed=2))
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss)
    names = [n for n in ref_g if not n.endswith(("xpos", "ypos"))]
    got = np.concatenate([got_g[n].ravel() for n in names])
    want = np.concatenate([ref_g[n].ravel() for n in names])
    cos = float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert cos >= 0.98, cos
    assert np.linalg.norm(got - want) <= 0.25 * np.linalg.norm(want)
    agree = total = 0
    for name in ref_g:
        if name.endswith("xpos"):
            assert not got_g[name].any()
        elif name.endswith("ypos"):
            assert set(np.abs(got_g[name]).tolist()) <= {np.float32(0.01),
                                                         np.float32(1e-4)}
            agree += int((got_g[name] == ref_g[name]).sum())
            total += got_g[name].size
    # a position step flips where gy_raw sits at bf16 roundoff
    assert agree >= 0.9 * total, (agree, total)


def test_weight_decay_table_matches_reference():
    model = Model(config_from_reference_args(
        {"num_class": 2, "num_point": 33, "num_person": 1,
         "graph": "mediapipe_pose"}), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert len(names) > 100
    for name in names:
        assert optim.weight_decay_for_name(name) == weight_decay_for_path(
            tuple(name.split("."))), name
    groups = optim.build_param_groups(model)
    assert sorted(g["weight_decay"] for g in groups) == [0.0, 1e-4, 1e-3]
    assert sum(len(g["params"]) for g in groups) == len(names)


@pytest.mark.parametrize("warm_up", [0, 5])
def test_step_decay_lr_matches_reference(warm_up):
    for epoch in range(121):
        assert optim.step_decay_lr(epoch, 0.1, [60, 80, 100], warm_up) == \
            jax_step_decay_lr(epoch, 0.1, [60, 80, 100], warm_up)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((6, 3)).astype(np.float32) * 3
    labels = rng.integers(0, 3, 6).astype(np.int32)
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    for m in (None, mask):
        want = jax_state.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = state.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_init_draws_reference_distributions():
    cfg = dataclasses.replace(config_from_reference_args(ARGS),
                              shift_init_scale=2.0)
    model = Model(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    again = Model(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    for (name, p), q in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(p, q), name
    sd = model.state_dict()
    ypos = sd["l2.tcn1.shift_out.ypos"]
    assert 1.0 < float(ypos.abs().max()) <= 2.0
    assert float(sd["l2.tcn1.shift_in.xpos"].abs().max()) <= 1e-8
    assert torch.all(sd["l1.gcn1.Feature_Mask"] == 0)
    assert torch.all(sd["l2.residual.bn.weight"] == 1)
    fc_bound = 1.0 / np.sqrt(16)
    assert float(sd["fc.bias"].abs().max()) <= fc_bound
    assert float(sd["l1.tcn1.temporal_linear.bias"].abs().max()) <= (
        1.0 / np.sqrt(8))


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


def test_batch_iterator_matches_reference(tmp_path):
    paths = _write_dataset(str(tmp_path), 20, 16, 0)
    args = dict(random_choose=True, window_size=12, random_move=True,
                random_shift=True)
    ours = feeder.BatchIterator(feeder.Feeder(**paths, **args), 6,
                                shuffle=True, drop_last=True, seed=5)
    ref = jax_feeder.BatchIterator(jax_feeder.Feeder(**paths, **args), 6,
                                   shuffle=True, drop_last=True, seed=5)
    for epoch in (0, 3):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    test = feeder.BatchIterator(feeder.Feeder(**paths), 8)
    last = list(test.epoch(0))[-1]
    np.testing.assert_array_equal(last[3], [1, 1, 1, 1, 0, 0, 0, 0])
    np.testing.assert_array_equal(last[2], [16, 17, 18, 19, -1, -1, -1, -1])


CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "mediapipe",
                                        "*.yaml"))) + [
    os.path.join(REPO, "configs", "smoke.yaml")]
# every MediaPipe config parses now: train_seqpar.yaml's [4, 2] sequence
# parallelism is ported (A13); its world size is checked by the Trainer
REFUSED = {}


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_matches_reference(path):
    name = os.path.basename(path)
    if name in REFUSED:
        with pytest.raises(ValueError, match=f"'{REFUSED[name]}'.*ROADMAP"):
            config.load_config(["--config", path])
        return
    got = dataclasses.asdict(config.load_config(
        ["--config", path, "--base_lr", "0.05"]))
    want = dataclasses.asdict(jax_config.load_config(
        ["--config", path, "--base_lr", "0.05"]))
    assert got.pop("feeder") == "shift_gcn_torch.data.feeder.Feeder"
    assert got.pop("model") == "shift_gcn_torch.models.shift_gcn"
    want.pop("feeder"), want.pop("model")
    assert got == want


def test_load_config_refuses_other_family_and_unknown_keys():
    # the other families and the lowering knobs are ported (A11, A12),
    # and the edge partition (A13c): only the layouts the reference
    # trainer refuses are refused, such as the edge partition of a family
    # without an edge path, and unknown keys
    assert config.load_config(["--model", "stgcn"]).model == "stgcn"
    assert config.load_config(["--lowering", "{tshift_impl: conv}"]
                              ).lowering == {"tshift_impl": "conv"}
    with pytest.raises(ValueError, match="edge_partition is not supported "
                       "by model family 'shift_gcn'"):
        config.load_config(["--model", "shift_gcn", "--mesh_shape", "1",
                            "4", "--edge_partition", "true"])
    with pytest.raises(KeyError, match="WRONG ARG"):
        config.load_config(["--no_such_key", "1"])


def test_trainer_and_cli_need_cuda_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(config.ExperimentConfig(work_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main(["--work_dir", str(tmp_path)])


def test_trainer_end_to_end_resume_and_reference_readback(tmp_path,
                                                          interpret):
    paths = _write_dataset(str(tmp_path), 16, 32, 3)
    common = [
        "--config", os.path.join(REPO, "configs", "smoke.yaml"),
        "--work_dir", str(tmp_path / "work"),
        "--model_saved_name", str(tmp_path / "save"),
        "--train_feeder_args", repr(paths), "--test_feeder_args", repr(paths),
        "--model_args", repr(ARGS), "--batch_size", "8",
        "--test_batch_size", "6", "--save_interval", "1",
        "--eval_interval", "1", "--log_interval", "100"]
    best = cli_train.main(common + ["--torch-device", "cpu"])
    save_dir = tmp_path / "save" / "smoke"
    eval_dir = tmp_path / "work" / "smoke" / "eval_results"
    assert sorted(os.listdir(save_dir)) == ["smoke-0-2.pt", "smoke-1-4.pt"]
    assert (eval_dir / "best_acc.pkl").exists()
    assert len(list(eval_dir.glob("epoch_1_*.pkl"))) == 1
    assert 0.0 < best <= 1.0

    # resume continues at the next epoch, with the saved step count
    trainer = Trainer(config.load_config(
        common + ["--num_epoch", "3", "--resume", "auto"]), device="cpu")
    assert (trainer.start_epoch, trainer.global_step) == (2, 4)
    trainer.start()
    assert (save_dir / "smoke-2-6.pt").exists()

    # the reference package reads the port's checkpoint: equal eval logits
    params, bn_state, meta = jax_load_reference_checkpoint(
        str(save_dir / "smoke-2-6.pt"))
    assert meta["epoch"] == 2 and meta["global_step"] == 6
    data = np.load(paths["data_path"])[:6]
    want, _ = jax_model.apply(params, bn_state, jnp.asarray(data),
                              _jax_config(), training=False)
    with torch.no_grad():
        got = trainer.model.eval()(torch.from_numpy(data))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
    scores = pickle.load(open(eval_dir / "best_acc.pkl", "rb"))
    assert len(scores) == 16
