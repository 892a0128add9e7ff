"""The port's tensor parallelism (``parallel/tensor.py``) in gloo
processes on the CPU (tests/torch_parallel_ranks.py, jobs ``tp`` on 2
ranks and ``tp22`` on 4), against the reference package's train and
eval steps on a (1, 2) and a (2, 2) mesh of its virtual CPU devices with
the state committed to ``mesh.state_shardings`` (the output channels of
``Linear_weight`` and ``temporal_linear.weight`` and of their momentum
over 'model'), and against the port's one-process step, from the same
weights and batch:

- each rank holds its own slices: ``Linear_weight`` (C_in, C_out / M),
  ``temporal_linear.weight`` (C_out / M, C_in, 1, 1);
- the loss, every true gradient (the sharded ones gathered), the ypos
  constraint steps (bit-equal), the parameters and the momentum after
  SGD and the BN running statistics, within the tolerances of
  tests/torch_parallel_helpers.py; the eval logits, loss sum and count;
- the [1, 2] step with ``remat`` bit-equal to the step without it;
- a four-stream [1, 2] step (``param_spec`` on the stream-stacked
  trees) and an ST-GCN [1, 2] step (no sharded parameter: fully
  replicated) against their one-process steps;
- the channel gather's forward and its adjoint (the ranks' cotangents
  summed, this rank's slice kept)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_tpu.parallel import mesh as jax_mesh_lib
from shift_gcn_tpu.train import fourstream as jax_fs
from shift_gcn_tpu.train import state as jax_state
from shift_gcn_tpu.train.optim import build_weight_decay_tree
from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.train import fourstream
from torch_parallel_helpers import (
    ARGS, LR, assert_step_matches, flat, jax_mesh, model_inputs)
from torch_parallel_ranks import run_ranks

STGCN_ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
              "graph": "mediapipe_pose", "channels": [8, 16],
              "strides": [1, 2]}
GRAD_TOL = (1e-5, 2e-4)  # absolute, and of the gradient's scale


def _gather_inputs():
    rng = np.random.default_rng(5)
    return {"x": rng.standard_normal((3, 5, 8)).astype(np.float32),
            "cot": rng.standard_normal((2, 3, 5, 8)).astype(np.float32)}


def _fourstream_inputs(seed):
    cfg = jax_model.config_from_reference_args(ARGS)
    state4 = jax_fs.create_fourstream_state(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed + 100)
    return {"args": ARGS, "lr": LR, "seed": seed,
            "params4": jax.tree_util.tree_map(np.asarray, state4.params),
            "bn4": jax.tree_util.tree_map(np.asarray, state4.bn_state),
            "parents": get_graph("mediapipe_pose").bone_parents(),
            "data": rng.standard_normal((4, 3, 16, 33, 1)).astype(
                np.float32),
            "label": rng.integers(0, 2, 4).astype(np.int32)}


def _stgcn_inputs(seed):
    rng = np.random.default_rng(seed)
    return {"args": STGCN_ARGS, "lr": LR, "seed": seed,
            "data": rng.standard_normal((4, 3, 16, 33, 1)).astype(
                np.float32),
            "label": rng.integers(0, 2, 4).astype(np.int32),
            "mask": np.asarray([1, 1, 1, 0], np.float32)}


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    inputs = {"model": model_inputs(seed=3, t=32),
              "fourstream": _fourstream_inputs(seed=4),
              "stgcn": _stgcn_inputs(seed=6), "gather": _gather_inputs()}
    outs = run_ranks("tp", tmp_path_factory.mktemp("tp"), 2, inputs)
    outs22 = run_ranks("tp22", tmp_path_factory.mktemp("tp22"), 4,
                       {"model": inputs["model"]})
    return inputs, outs, outs22


def _jax_tp(c, shape):
    """The reference's gradients, step, metrics and eval outputs with its
    state committed to the tensor-parallel shardings of a ``shape``
    mesh, the batch over 'data'."""
    cfg = jax_model.config_from_reference_args(ARGS)
    mesh = jax_mesh(shape)
    state = jax_state.create_train_state(jax.random.key(c["seed"]), cfg)
    state = jax.device_put(state, jax_mesh_lib.state_shardings(mesh, state))
    lw = state.params["l1"]["gcn1"]["Linear_weight"]
    assert not lw.sharding.is_fully_replicated
    sharding = NamedSharding(mesh, P("data"))
    data, label, mask = (jax.device_put(jnp.asarray(c[k]), sharding)
                         for k in ("data", "label", "mask"))

    def loss_fn(params):
        logits, _ = jax_model.apply(params, state.bn_state, data, cfg,
                                    training=True)
        return jax_state.cross_entropy(logits, label)

    grads = flat(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss_fn))(state.params)))
    step = jax_state.make_train_step(
        cfg, build_weight_decay_tree(c["params"]))
    new_state, metrics = jax.jit(step)(
        state, {"data": data, "label": label}, jnp.float32(c["lr"]))
    evaluated = jax.jit(jax_state.make_eval_step(cfg))(
        state.params, state.bn_state,
        {"data": data, "label": label, "mask": mask})
    return grads, new_state, metrics, evaluated


def _assert_close_steps(got, want, label):
    """A tensor-parallel step against the one-process step of the port."""
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * max(
        1.0, abs(want["loss"])), label
    for name, ref in want["grads"].items():
        if name.endswith("pos"):
            np.testing.assert_array_equal(got["grads"][name], ref,
                                          err_msg=f"{label} {name}")
        else:
            np.testing.assert_allclose(
                got["grads"][name], ref, rtol=0, atol=GRAD_TOL[0]
                + GRAD_TOL[1] * float(np.abs(ref).max()),
                err_msg=f"{label} {name}")
    for name, ref in want["state"].items():
        np.testing.assert_allclose(
            got["state"][name], ref, rtol=0,
            atol=1e-6 + 1e-5 * float(np.abs(ref).max()),
            err_msg=f"{label} {name}")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_tp_steps_match_reference(tp_run, shape):
    inputs, outs, outs22 = tp_run
    c = inputs["model"]
    ranks = [o["tp12"] for o in outs] if shape == (1, 2) else [
        o["tp22"] for o in outs22]
    grads, new_state, metrics, (logits, loss_sum, n) = _jax_tp(c, shape)
    momentum = flat(jax.tree_util.tree_map(
        np.asarray, new_state.opt_state.momentum_buf))
    m = shape[1]
    for out in ranks:
        assert out["shapes"] == {
            "l1.gcn1.Linear_weight": (3, 8 // m),
            "l1.tcn1.temporal_linear.weight": (8 // m, 8, 1, 1),
            "l2.gcn1.Linear_weight": (8, 16 // m),
            "l2.tcn1.temporal_linear.weight": (16 // m, 16, 1, 1)}
        assert_step_matches(out, c, grads, new_state, metrics)
        for name, want in momentum.items():
            np.testing.assert_allclose(
                out["momentum"][name], want, rtol=0, atol=GRAD_TOL[0]
                + GRAD_TOL[1] * float(np.abs(want).max()), err_msg=name)
        _assert_close_steps(out, out["single"], f"{shape} vs one process")
        np.testing.assert_allclose(out["logits"], np.asarray(logits),
                                   rtol=0, atol=1e-5 * max(
                                       1.0, float(np.abs(logits).max())))
        assert abs(out["loss_sum"] - float(loss_sum)) <= 1e-5 * max(
            1.0, abs(float(loss_sum)))
        assert out["n"] == float(n) == 3.0


def test_tp_remat_step_equals_plain(tp_run):
    # the recomputed units gather their channel slices again in the
    # backward: the same bits
    _, outs, _ = tp_run
    for out in outs:
        plain, remat = out["tp12"], out["tp12_remat"]
        assert remat["loss"] == plain["loss"]
        for part in ("grads", "state", "momentum"):
            assert remat[part].keys() == plain[part].keys()
            for name, want in plain[part].items():
                np.testing.assert_array_equal(remat[part][name], want,
                                              err_msg=f"{part} {name}")


def test_fourstream_tp_1x2_step_matches_reference(tp_run):
    inputs, outs, _ = tp_run
    c = inputs["fourstream"]
    cfg = jax_model.config_from_reference_args(ARGS)
    mesh = jax_mesh((1, 2))
    state4 = jax_fs.create_fourstream_state(jax.random.key(c["seed"]), cfg)
    # param_spec on the stream-stacked trees
    state4 = jax.device_put(state4,
                            jax_mesh_lib.state_shardings(mesh, state4))
    wd = build_weight_decay_tree(jax.tree_util.tree_map(
        lambda x: x[0], state4.params))
    step4 = jax.jit(jax_fs.make_fourstream_train_step(
        cfg, wd, jax_fs.graph_for_config(cfg)))
    sharding = NamedSharding(mesh, P("data"))
    joint = jax.device_put(jnp.asarray(c["data"]), sharding)
    label = jax.device_put(jnp.asarray(c["label"]), sharding)
    new4, metrics = step4(state4, {"data": joint, "label": label},
                          jnp.float32(c["lr"]))

    def loss_fn(p, s, data):
        logits, _ = jax_model.apply(p, s, data, cfg, training=True)
        return jax_state.cross_entropy(logits, label)

    grad_fn = jax.jit(jax.grad(loss_fn))
    data4 = jax_fs.derive_modalities_device(joint, c["parents"])
    for i, stream in enumerate(fourstream.STREAMS):
        def pick(x, i=i):
            return x[i]

        grads = flat(jax.tree_util.tree_map(np.asarray, grad_fn(
            jax.tree_util.tree_map(pick, state4.params),
            jax.tree_util.tree_map(pick, state4.bn_state), data4[i])))
        new_state = new4._replace(
            params=jax.tree_util.tree_map(pick, new4.params),
            bn_state=jax.tree_util.tree_map(pick, new4.bn_state))
        for out in outs:
            got = out["fourstream"]
            assert_step_matches(
                {"loss": float(got["losses"][i]),
                 "grads": got["grads"][stream],
                 "state": got["state"][stream]}, c, grads, new_state,
                {"loss": metrics["loss"][i]})


def test_stgcn_tp_1x2_step_is_replicated(tp_run):
    # ST-GCN has neither sharded parameter: it runs whole on both model
    # ranks, with BN over the data ranks alone
    _, outs, _ = tp_run
    for out in outs:
        got = out["stgcn"]
        assert got["shapes"] == {}
        _assert_close_steps(got, got["single"], "ST-GCN [1, 2]")
    np.testing.assert_array_equal(outs[0]["stgcn"]["logits"],
                                  outs[1]["stgcn"]["logits"])


def test_gather_channels_and_its_adjoint(tp_run):
    inputs, outs, _ = tp_run
    c = inputs["gather"]
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["gather"]["out"], c["x"])
        np.testing.assert_allclose(
            out["gather"]["grad"],
            c["cot"].sum(0)[..., rank * 4:(rank + 1) * 4], rtol=1e-6)
