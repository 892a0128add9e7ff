"""Per-unit recomputation (``remat``) and the Trainer's ``profile_dir`` /
``profile_steps`` and ``debug_nans`` keys on the CPU.

A step with ``remat`` equals the step without it bit for bit (loss,
parameters, momentum, BN buffers), in one process, in four streams and
over three steps, and the hooks show each unit run twice; it matches the
reference package's ``remat=True`` step from the same weights within
``test_torch_train.py``'s step tolerances; ST-GCN ignores the key, as the
reference trainer does; the eval forward is unchanged.  A CPU Trainer
run with ``profile_dir`` writes one trace of ``profile_steps`` steps;
``debug_nans`` raises ``FloatingPointError`` naming the module that got
a planted NaN, and registers nothing when it is off."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.models.shift_gcn import (
    BlockSpec, Model, ModelConfig, TCNGCNUnit)
from shift_gcn_torch.train import config, fourstream, optim, state
from shift_gcn_torch.train.trainer import Trainer, nan_check
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays
from test_torch_train import (  # noqa: F401 (fixtures)
    ARGS, REPO, _assert_grads, _flat, _lockstep, _write_dataset,
    interpret, no_onednn)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # at these widths torch's intra-op pool buys nothing, and while other
    # test workers hold the host's cores a Trainer run in it stalled for
    # over a minute (under a second on one thread)
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _config(remat, **kw):
    # as tests/test_model_options.py's: a down conv without residual, a
    # stride-2 unit with a residual conv; V=25, T=16
    return ModelConfig(
        num_class=2, num_point=25, num_person=1, graph="ntu_rgb_d",
        blocks=(BlockSpec(3, 8, residual=False),
                BlockSpec(8, 16, stride=2)), remat=remat, **kw)


def _batch(seed, n=4, t=16, v=25):
    rng = np.random.default_rng(seed)
    return {"data": torch.from_numpy(rng.standard_normal(
                (n, 3, t, v, 1)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, 2, n)).long()}


def _count_runs(model):
    """Calls per unit (pre-hook) and per gcn1 / tcn1 (forward hook).  The
    recomputation stops at a unit's last saved tensor, the output of its
    final ReLU, before the unit's forward returns: so its own forward
    hook fires once, its pre-hook and its children's hooks twice."""
    calls = {}

    def count(name):
        def hook(*_):
            calls[name] = calls.get(name, 0) + 1
        return hook

    for name, module in model.named_modules():
        if isinstance(module, TCNGCNUnit):
            module.register_forward_pre_hook(count(name))
            module.gcn1.register_forward_hook(count(name + ".gcn1"))
            module.tcn1.register_forward_hook(count(name + ".tcn1"))
    return calls


def _snapshot(model, opt):
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {n: opt.state[p]["momentum_buffer"].clone()
             for n, p in model.named_parameters()})


def _assert_bit_equal(got, want):
    for part_got, part_want in zip(got, want):
        assert part_got.keys() == part_want.keys()
        for k, v in part_want.items():
            assert torch.equal(part_got[k], v), k


def test_remat_step_is_bit_equal_and_recomputes():
    out = {}
    for remat in (False, True):
        model = Model(_config(remat), device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        calls = _count_runs(model)
        opt = optim.build_optimizer(model, 0.1)
        loss, acc = state.train_step(model, opt, _batch(0), 0.1)
        out[remat] = (loss, acc, _snapshot(model, opt), calls)
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    _assert_bit_equal(out[True][2], out[False][2])
    # one running-statistics update per BN, not two
    for k, v in out[True][2][0].items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k
    names = sorted(out[False][3])
    assert out[False][3] == {n: 1 for n in names}
    assert out[True][3] == {n: 2 for n in names}


def test_remat_step_matches_reference(interpret):
    # the tolerances of test_torch_train.py's
    # test_one_train_step_matches_reference
    ref_loss, loss, ref_g, got_g, ts, model = next(
        _lockstep(None, [0.1], seed=0, remat=True))
    assert model.config.remat
    assert abs(loss - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    _assert_grads(ref_g, got_g, 1e-5, 2e-4)
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


def test_remat_fourstream_and_three_steps_are_bit_equal():
    parents = torch.as_tensor(get_graph("ntu_rgb_d").bone_parents())
    lrs = [optim.step_decay_lr(e, 0.1, [2], warm_up_epoch=2)
           for e in range(3)]
    out = {}
    for remat in (False, True):
        models = fourstream.create_models(_config(remat), 0, "cpu")
        opts = {s: optim.build_optimizer(m, 0.1) for s, m in models.items()}
        losses, accs = fourstream.train_step(models, opts, _batch(1), 0.1,
                                             parents)
        single = Model(_config(remat), device="cpu").init_weights(
            torch.Generator().manual_seed(3))
        opt = optim.build_optimizer(single, lrs[0])
        steps = [state.train_step(single, opt, _batch(10 + i), lr)[0]
                 for i, lr in enumerate(lrs)]
        out[remat] = (losses, accs, {s: _snapshot(m, opts[s])
                                     for s, m in models.items()},
                      torch.stack(steps), _snapshot(single, opt))
    plain, remat = out[False], out[True]
    assert torch.equal(remat[0], plain[0]) and torch.equal(remat[1],
                                                           plain[1])
    for stream in fourstream.STREAMS:
        _assert_bit_equal(remat[2][stream], plain[2][stream])
    assert torch.equal(remat[3], plain[3])
    _assert_bit_equal(remat[4], plain[4])


def test_eval_forward_is_unchanged_under_remat():
    batch = _batch(2)["data"]
    logits = {}
    for remat in (False, True):
        model = Model(_config(remat), device="cpu").init_weights(
            torch.Generator().manual_seed(0))
        calls = _count_runs(model)
        with torch.no_grad():
            logits[remat] = state.eval_step(model, {
                "data": batch, "label": torch.zeros(4, dtype=torch.long)})[0]
            model.train()(batch)  # training mode without grad: no remat
        assert set(calls.values()) == {2}, calls
    assert torch.equal(logits[True], logits[False])


def _trainer_config(tmp_path, name, *extra):
    paths = _write_dataset(str(tmp_path), 16, 32, 3)
    return config.load_config([
        "--config", os.path.join(REPO, "configs", "smoke.yaml"),
        "--Experiment_name", name,
        "--work_dir", str(tmp_path / "work"),
        "--model_saved_name", str(tmp_path / "save"),
        "--train_feeder_args", repr(paths), "--test_feeder_args",
        repr(paths), "--model_args", repr(ARGS), "--batch_size", "4",
        "--test_batch_size", "8", "--num_epoch", "1", "--log_interval",
        "100", *extra])


def _hooks(model):
    return [m for m in model.modules()
            if m._forward_hooks or m._forward_pre_hooks]


def test_trainer_profile_dir_traces_the_first_steps(tmp_path, interpret):
    trace_dir = tmp_path / "trace"
    trainer = Trainer(_trainer_config(
        tmp_path, "traced", "--remat", "true", "--profile_dir",
        str(trace_dir), "--profile_steps", "2"), device="cpu")
    assert trainer.model.config.remat
    assert not _hooks(trainer.model)  # debug_nans is off
    trainer.start()
    traces = glob.glob(str(trace_dir / "*"))
    assert len(traces) == 1
    assert os.path.basename(traces[0]).startswith("rank0.")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    steps = {e["name"] for e in events
             if str(e.get("name", "")).startswith("ProfilerStep#")}
    assert steps == {"ProfilerStep#0", "ProfilerStep#1"}
    assert any(e.get("name") == "aten::convolution" for e in events)
    with open(tmp_path / "work" / "traced" / "log.txt") as f:
        lines = [line for line in f if "Profiler trace written to" in line]
    assert len(lines) == 1 and str(trace_dir) in lines[0]


def test_trainer_debug_nans_names_the_module(tmp_path, interpret):
    trainer = Trainer(_trainer_config(tmp_path, "nans", "--debug_nans",
                                      "true"), device="cpu")
    assert len(_hooks(trainer.model)) == len(list(trainer.model.modules()))
    trainer.start()  # clean data trains; no trace without profile_dir
    assert np.isfinite(trainer.best_acc)
    assert not glob.glob(str(tmp_path / "**" / "*.pt.trace.json"),
                         recursive=True)
    batch = _batch(4, t=32, v=33)
    batch["data"][1, 0, 5, 7, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="data_bn"):
        trainer._train_step(batch, 0.1)
    # a NaN first made by a backward function is named there
    x = torch.zeros((), requires_grad=True)
    with pytest.raises(FloatingPointError, match="SqrtBackward0"):
        with nan_check():
            (torch.sqrt(x) * 0).backward()


def test_stgcn_ignores_remat(tmp_path):
    cfg = dataclasses.replace(
        _trainer_config(tmp_path, "stgcn", "--remat", "true"),
        model="stgcn", model_args={
            "num_class": 2, "num_point": 33, "num_person": 1,
            "graph": "mediapipe_pose", "channels": [8], "strides": [1]})
    trainer = Trainer(cfg, device="cpu")
    assert not hasattr(trainer.model_config, "remat")
    loss, _ = trainer._train_step(_batch(5, t=32, v=33), 0.1)
    assert np.isfinite(float(loss))
