"""Shared inputs and checks of the port's multi-process parity tests
(tests/test_torch_parallel_*.py): the small model, its seeded reference
weights and batch, the reference step's gradients and new state, and the
comparison of a rank's step with them."""

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_tpu.parallel import seqpar as jax_seqpar
from shift_gcn_tpu.train import state as jax_state
from shift_gcn_tpu.train.optim import build_weight_decay_tree
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

# 2 units: a down conv (3->8, no residual) and a stride-2 unit with a
# residual conv (8->16); V=33
ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
        "graph": "mediapipe_pose",
        "blocks": [[3, 8, 1, False], [8, 16, 2]]}
LR = 0.1


def model_inputs(seed, t, n=4):
    """Reference weights from ``seed`` and a batch of n clips of t
    frames, as numpy."""
    cfg = jax_model.config_from_reference_args(ARGS)
    state = jax_state.create_train_state(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed + 100)
    return {"args": ARGS, "lr": LR, "seed": seed,
            "params": jax.tree_util.tree_map(np.asarray, state.params),
            "bn_state": jax.tree_util.tree_map(np.asarray, state.bn_state),
            "data": rng.standard_normal((n, 3, t, 33, 1)).astype(np.float32),
            "label": rng.integers(0, 2, n).astype(np.int32),
            "mask": np.asarray([1] * (n - 1) + [0], np.float32)}


def flat(tree):
    """Reference parameter tree -> {port parameter name: array}."""
    return {k: v.numpy() for k, v in state_dict_from_arrays(tree, {}).items()
            if not k.endswith(("shift_in", "shift_out"))}


def jax_grads_and_step(c, apply, step, put=jnp.asarray):
    """(gradients {port name: array}, new TrainState, metrics) of the
    reference: ``apply(params, bn_state, data) -> (logits, bn_state)``
    is the program whose step ``step`` takes; ``put`` places the batch."""
    cfg = jax_model.config_from_reference_args(ARGS)
    state = jax_state.create_train_state(jax.random.key(c["seed"]), cfg)
    data, label = put(c["data"]), put(c["label"])

    def loss_fn(params):
        logits, _ = apply(params, state.bn_state, data)
        return jax_state.cross_entropy(logits, label)

    grads = jax.jit(jax.grad(loss_fn))(state.params)
    new_state, metrics = jax.jit(step)(
        state, {"data": data, "label": label}, jnp.float32(c["lr"]))
    return (flat(jax.tree_util.tree_map(np.asarray, grads)),
            new_state, metrics)


def assert_step_matches(out, c, grads, new_state, metrics):
    """A rank's train step against the reference's: the loss at fp32
    roundoff; true gradients within 1e-5 + 2e-4 of their scale (another
    summation order through the model, as tests/test_torch_train.py);
    xpos zero and the ypos constraint steps bit-equal; parameters after
    SGD within those gradients' roundoff times lr * (1 + momentum); the
    BN running statistics at fp32 roundoff."""
    ref_loss = float(metrics["loss"])
    assert abs(out["loss"] - ref_loss) <= 1e-5 * max(1.0, abs(ref_loss))
    got = out["grads"]
    assert set(got) == set(grads)
    for name, want in grads.items():
        if name.endswith("xpos"):
            assert not got[name].any(), name
        elif name.endswith("ypos"):
            np.testing.assert_array_equal(got[name], want, err_msg=name)
        else:
            np.testing.assert_allclose(
                got[name], want, rtol=0,
                atol=1e-5 + 2e-4 * float(np.abs(want).max()), err_msg=name)
    new_params = flat(jax.tree_util.tree_map(np.asarray, new_state.params))
    for name, want in new_params.items():
        tol = 1e-6 + 0.19 * (1e-5 + 2e-4 * float(np.abs(grads[name]).max()))
        np.testing.assert_allclose(out["state"][name], want, rtol=0,
                                   atol=tol, err_msg=name)
    stats = state_dict_from_arrays({}, jax.tree_util.tree_map(
        np.asarray, new_state.bn_state))
    for name, want in stats.items():
        np.testing.assert_allclose(out["state"][name], want.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def jax_mesh(shape):
    return Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(
        shape), ("data", "model"))


def _jax_seqpar(c, shape):
    cfg = jax_model.config_from_reference_args(ARGS)
    mesh = jax_mesh(shape)
    data_spec = P("data", None, "model")

    def apply(params, bn_state, data):
        return jax.shard_map(
            lambda p, s, d: jax_model.apply(
                p, s, d, cfg, training=True, axis_name=("data", "model"),
                time_axis="model"),
            mesh=mesh, in_specs=(P(), P(), data_spec),
            out_specs=(P("data"), P()))(params, bn_state, data)

    wd = build_weight_decay_tree(c["params"])
    step = jax_seqpar.make_time_sharded_train_step(cfg, wd, mesh)
    evaluate = jax_seqpar.make_time_sharded_eval_step(cfg, mesh)
    return apply, step, evaluate


def check_seqpar_step(c, outs, shape):
    apply, step, evaluate = _jax_seqpar(c, shape)
    grads, new_state, metrics = jax_grads_and_step(c, apply, step)
    for out in outs:
        assert_step_matches(out, c, grads, new_state, metrics)
    logits, loss_sum, n = jax.jit(evaluate)(
        *(jax.tree_util.tree_map(jnp.asarray, c[k])
          for k in ("params", "bn_state")),
        {"data": jnp.asarray(c["data"]), "label": jnp.asarray(c["label"]),
         "mask": jnp.asarray(c["mask"])})
    for out in outs:
        np.testing.assert_allclose(out["logits"], np.asarray(logits),
                                   rtol=0, atol=1e-5 * max(
                                       1.0, float(np.abs(logits).max())))
        assert abs(out["loss_sum"] - float(loss_sum)) <= 1e-5 * max(
            1.0, abs(float(loss_sum)))
        assert out["n"] == float(n)
