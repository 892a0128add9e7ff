"""The port's data-parallel [2, 1] and sequence-parallel [1, 2] train and
eval steps, and its four-stream data-parallel step, in 2 gloo processes
on the CPU (tests/torch_parallel_ranks.py, job ``steps``), against the
reference package's on a (2, 1) and a (1, 2) mesh of its virtual CPU
devices, from the same weights and batch: the loss, every true gradient,
the ypos constraint steps (bit-equal), the parameters after SGD and the
BN running statistics (tolerances in torch_parallel_helpers.py), and the
eval logits, loss sum and count; every rank's results alike.  The [2, 1]
and [1, 2] steps with ``remat`` equal those without it bit for bit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_tpu.train import fourstream as jax_fs
from shift_gcn_tpu.train import state as jax_state
from shift_gcn_tpu.train.optim import build_weight_decay_tree
from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.train import fourstream
from torch_parallel_ranks import run_ranks
from torch_parallel_helpers import (
    ARGS, LR, assert_step_matches, check_seqpar_step, flat,
    jax_grads_and_step, model_inputs)


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


@pytest.fixture(scope="module")
def steps_run(tmp_path_factory):
    inputs = {"model": model_inputs(seed=1, t=64),
              "fourstream": _fourstream_inputs(seed=2)}
    outs = run_ranks("steps", tmp_path_factory.mktemp("steps"), 2, inputs)
    return inputs, outs


def _data_mesh():
    return Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                ("data", "model"))


def test_dp_2x1_steps_match_reference(steps_run):
    inputs, outs = steps_run
    c = inputs["model"]
    cfg = jax_model.config_from_reference_args(ARGS)
    sharding = NamedSharding(_data_mesh(), P("data"))

    def put(a):
        return jax.device_put(jnp.asarray(a), sharding)

    def apply(params, bn_state, data):
        return jax_model.apply(params, bn_state, data, cfg, training=True)

    step = jax_state.make_train_step(
        cfg, build_weight_decay_tree(c["params"]))
    grads, new_state, metrics = jax_grads_and_step(c, apply, step, put)
    for out in outs:
        assert_step_matches(out["dp21"], c, grads, new_state, metrics)
    logits, loss_sum, n = jax.jit(jax_state.make_eval_step(cfg))(
        *(jax.tree_util.tree_map(jnp.asarray, c[k])
          for k in ("params", "bn_state")),
        {"data": put(c["data"]), "label": put(c["label"]),
         "mask": put(c["mask"])})
    for out in outs:
        got = out["dp21"]
        np.testing.assert_allclose(got["logits"], np.asarray(logits),
                                   rtol=0, atol=1e-5 * max(
                                       1.0, float(np.abs(logits).max())))
        assert abs(got["loss_sum"] - float(loss_sum)) <= 1e-5 * max(
            1.0, abs(float(loss_sum)))
        assert got["n"] == float(n) == 3.0


def test_seqpar_1x2_steps_match_reference(steps_run):
    inputs, outs = steps_run
    check_seqpar_step(inputs["model"], [o["seqpar12"] for o in outs],
                      (1, 2))


@pytest.mark.parametrize("case", ["dp21", "seqpar12"])
def test_remat_steps_equal_plain(steps_run, case):
    # per-unit recomputation, its collectives (sync BN, the halo exchange)
    # issued again in the backward on every rank: the same bits
    _, outs = steps_run
    for out in outs:
        plain, remat = out[case], out[f"{case}_remat"]
        assert remat["loss"] == plain["loss"]
        for part in ("grads", "state", "momentum"):
            assert remat[part].keys() == plain[part].keys()
            for name, want in plain[part].items():
                np.testing.assert_array_equal(remat[part][name], want,
                                              err_msg=f"{part} {name}")


def test_fourstream_dp_2x1_step_matches_reference(steps_run):
    inputs, outs = steps_run
    c = inputs["fourstream"]
    cfg = jax_model.config_from_reference_args(ARGS)
    sharding = NamedSharding(_data_mesh(), P("data"))
    state4 = jax_fs.create_fourstream_state(jax.random.key(c["seed"]), cfg)
    wd = build_weight_decay_tree(jax.tree_util.tree_map(
        lambda x: x[0], state4.params))
    step4 = jax.jit(jax_fs.make_fourstream_train_step(
        cfg, wd, jax_fs.graph_for_config(cfg)))
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
