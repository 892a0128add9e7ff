"""The port's parallel ops in 4 gloo processes on the CPU
(tests/torch_parallel_ranks.py, job ``ops``) against the reference
package's on the same mesh shape of its 8 virtual CPU devices: the
halo-exchanged temporal shift (parallel/halo.py), the global
constraint, sync BN in each layout, and the [2, 2] sequence-parallel
train and eval steps; and ``validate_time_sharding``'s rejections.

Tolerances: forward and grad_input of the sharded shift bit-equal to the
port's unsharded op (the kept rows are K1's own rows, and the two
partial sums of a boundary frame's gradient add to the unsharded sum),
1e-5 of scale against the reference; every constraint position step
bit-equal; sync BN at 1e-5 of scale; the model steps at the tolerances of
tests/test_torch_train.py (fp32 roundoff of another summation order)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_tpu.ops import temporal_shift as jax_temporal_shift
from shift_gcn_tpu.ops.batchnorm import batch_norm as jax_batch_norm
from shift_gcn_tpu.ops.lowering import Lowering
from shift_gcn_tpu.parallel import halo as jax_halo
from shift_gcn_tpu.parallel import seqpar as jax_seqpar
from shift_gcn_torch.models.shift_gcn import (
    ModelConfig, config_from_reference_args)
from shift_gcn_torch.parallel import seqpar
from torch_parallel_ranks import run_ranks
from torch_parallel_helpers import (
    ARGS, check_seqpar_step, jax_mesh, model_inputs)

HALO_MESHES = ((1, 4), (2, 2))
HALO_CASES = [(mesh, stride, max_shift) for mesh in HALO_MESHES
              for stride in (1, 2) for max_shift in (8, 16)]
BN_CASES = [(layout, mesh) for layout in ("C", "VC", "data_bn")
            for mesh in ((4, 1), (2, 2))]


def _halo_inputs(rng, mesh, stride, max_shift):
    # T=72: 18 frames a rank at M=4, >= max_shift + 1 = 17 and even
    n, t, v, c = 2, 72, 5, 6
    ypos = rng.uniform(-(max_shift - 1), max_shift - 1, c).astype(np.float32)
    ypos[0] = max_shift - 0.75  # reaches across a whole halo
    return {"mesh": mesh, "stride": stride, "max_shift": max_shift,
            "x": rng.standard_normal((n, t, v, c)).astype(np.float32),
            "g": rng.standard_normal((n, t // stride, v, c)).astype(
                np.float32),
            "xpos": rng.uniform(-1e-8, 1e-8, c).astype(np.float32),
            "ypos": ypos}


def _ramp_inputs(mesh, sharded):
    """x whose frame differences are +1 on three ranks' parts and -4 on
    the fourth's (rows under data parallelism, frames under sequence
    parallelism), with a cotangent of ones: each rank's local gy_raw has
    the sign of its slope, the global one is negative."""
    n, t, v, c = 4, 40, 3, 2
    slope = np.ones((n, t), np.float32)
    if sharded:
        slope[:, 30:] = -4.0
    else:
        slope[3] = -4.0
    x = np.cumsum(slope, axis=1)[:, :, None, None] * np.ones((1, 1, v, c),
                                                             np.float32)
    g = np.ones((n, t, v, c), np.float32)
    g[:, -1] = 0  # the last row reads past the end
    return {"mesh": mesh, "sharded": sharded, "stride": 1, "max_shift": 8,
            "x": x.astype(np.float32), "g": g,
            "xpos": np.zeros(c, np.float32),
            "ypos": np.full(c, 0.25, np.float32)}


def _bn_inputs(rng, layout, mesh):
    shape, feature_dims = {"C": ((8, 8, 5, 4), 1), "VC": ((8, 8, 5, 4), 2),
                           "data_bn": ((8, 8, 30), 1)}[layout]
    feats = int(np.prod(shape[len(shape) - feature_dims:]))
    return {"mesh": mesh, "feature_dims": feature_dims,
            "x": (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32),
            "cot": rng.standard_normal(shape).astype(np.float32),
            "weight": rng.uniform(0.5, 1.5, feats).astype(np.float32),
            "bias": rng.standard_normal(feats).astype(np.float32),
            "rm": rng.standard_normal(feats).astype(np.float32) * 0.1,
            "rv": rng.uniform(0.5, 1.5, feats).astype(np.float32)}


@pytest.fixture(scope="module")
def ops_run(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs = {
        "halo": {case: _halo_inputs(rng, *case) for case in HALO_CASES},
        "constraint": {"dp": _ramp_inputs((4, 1), False),
                       "seqpar": _ramp_inputs((1, 4), True)},
        "bn": {case: _bn_inputs(rng, *case) for case in BN_CASES},
        "model": model_inputs(seed=0, t=64),
    }
    outs = run_ranks("ops", tmp_path_factory.mktemp("ops"), 4, inputs)
    return inputs, outs


def _assemble(outs, part, key, field, shape, t_axis=1):
    """Every rank's block of a global array put back in place."""
    d_size, m_size = shape
    rows = []
    for d in range(d_size):
        blocks = [outs[d * m_size + m][part][key][field]
                  for m in range(m_size)]
        rows.append(np.concatenate(blocks, axis=t_axis)
                    if t_axis is not None else blocks[0])
    return np.concatenate(rows, axis=0)


def _port_unsharded(c):
    import torch

    from shift_gcn_torch.ops import temporal_shift as ts

    x = torch.from_numpy(c["x"]).requires_grad_(True)
    xpos = torch.nn.Parameter(torch.from_numpy(c["xpos"]))
    ypos = torch.nn.Parameter(torch.from_numpy(c["ypos"]))
    out = ts.temporal_shift(x, ypos, c["stride"], xpos=xpos)
    out.backward(torch.from_numpy(c["g"]))
    return out.detach().numpy(), x.grad.numpy(), ypos.grad.numpy()


@pytest.mark.parametrize("case", HALO_CASES, ids=str)
def test_sharded_shift_matches_unsharded_and_reference(ops_run, case):
    inputs, outs = ops_run
    c = inputs["halo"][case]
    shape, stride, max_shift = case
    out = _assemble(outs, "halo", case, "out", shape)
    dx = _assemble(outs, "halo", case, "dx", shape)
    want_out, want_dx, want_gy = _port_unsharded(c)
    np.testing.assert_array_equal(out, want_out)
    np.testing.assert_array_equal(dx, want_dx)
    for rank_out in outs:
        np.testing.assert_array_equal(rank_out["halo"][case]["gy"], want_gy)
        assert not rank_out["halo"][case]["gx"].any()

    mesh = jax_mesh(shape)
    batch_axes = ("data",)

    def fn(x, xpos, ypos):
        return jax.shard_map(
            lambda xb, xp, yp: jax_halo.sharded_temporal_shift_train(
                xb, xp, yp, stride, "model", batch_axes, max_shift),
            mesh=mesh, in_specs=(P("data", "model"), P(), P()),
            out_specs=P("data", "model"))(x, xpos, ypos)

    ref_out, vjp = jax.vjp(jax.jit(fn), jnp.asarray(c["x"]),
                           jnp.asarray(c["xpos"]), jnp.asarray(c["ypos"]))
    ref_dx, _, ref_gy = vjp(jnp.asarray(c["g"]))
    for got, want in ((out, ref_out), (dx, ref_dx)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(want_gy, np.asarray(ref_gy))


@pytest.mark.parametrize("kind", ["dp", "seqpar"])
def test_constraint_steps_on_the_global_gradient(ops_run, kind):
    inputs, outs = ops_run
    c = inputs["constraint"][kind]
    @jax.jit
    def position_step(x, xpos, ypos, g):
        _, vjp = jax.vjp(lambda x_, xp, yp: jax_temporal_shift(x_, xp, yp, 1),
                         x, xpos, ypos)
        return vjp(g)[2]

    global_step = np.asarray(position_step(
        *(jnp.asarray(c[k]) for k in ("x", "xpos", "ypos", "g"))))
    np.testing.assert_array_equal(global_step, np.float32(-0.01))
    for rank, rank_out in enumerate(outs):
        got = rank_out["constraint"][kind]
        np.testing.assert_array_equal(got["gy"], global_step)
        # a rank-local constraint would step the other way on ranks 0-2
        local_sign = np.sign(got["local_gy_raw"])
        assert (local_sign == (1 if rank < 3 else -1)).all(), (rank,
                                                                local_sign)
    if kind == "seqpar":
        x = _assemble(outs, "constraint", kind, "dx", (1, 4))
        np.testing.assert_array_equal(x, _port_unsharded(c)[1])


@pytest.mark.parametrize("case", BN_CASES, ids=str)
def test_sync_bn_matches_reference(ops_run, case):
    inputs, outs = ops_run
    c = inputs["bn"][case]
    layout, shape = case
    t_axis = 1 if shape[1] > 1 else None
    fd = c["feature_dims"]
    reduce_axes = tuple(range(c["x"].ndim - fd))
    mesh = jax_mesh(shape)
    spec = P("data", "model") if t_axis else P("data")
    params = {"weight": jnp.asarray(c["weight"]),
              "bias": jnp.asarray(c["bias"])}
    state = {"running_mean": jnp.asarray(c["rm"]),
             "running_var": jnp.asarray(c["rv"]),
             "num_batches_tracked": jnp.zeros((), jnp.int32)}

    def fn(x, params):
        return jax.shard_map(
            lambda xb, p: jax_batch_norm(
                xb, p, state, reduce_axes=reduce_axes, training=True,
                axis_name=("data", "model") if t_axis else "data",
                lp=False),
            mesh=mesh, in_specs=(spec, P()), out_specs=(spec, P()))(
                x, params)

    def loss(x, params):
        out, new_state = fn(x, params)
        return jnp.sum(out * jnp.asarray(c["cot"])), (out, new_state)

    (_, (ref_out, ref_state)), (ref_dx, ref_dp) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            jnp.asarray(c["x"]), params)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))

    close(_assemble(outs, "bn", case, "out", shape, t_axis), ref_out)
    close(_assemble(outs, "bn", case, "dx", shape, t_axis), ref_dx)
    close(sum(o["bn"][case]["dw"] for o in outs), ref_dp["weight"])
    close(sum(o["bn"][case]["db"] for o in outs), ref_dp["bias"])
    for o in outs:
        close(o["bn"][case]["rm"], ref_state["running_mean"])
        close(o["bn"][case]["rv"], ref_state["running_var"])
        assert o["bn"][case]["nbt"] == 1


def test_seqpar_2x2_steps_match_reference(ops_run):
    inputs, outs = ops_run
    check_seqpar_step(inputs["model"], [o["seqpar22"] for o in outs],
                      (2, 2))


def test_validate_time_sharding_rejections():
    full = ModelConfig(num_class=2, num_point=33, num_person=1,
                       graph="mediapipe_pose")
    jax_full = jax_model.ModelConfig(num_class=2, num_point=33,
                                     num_person=1, graph="mediapipe_pose")
    # T=300 at M=2: 150 -> 75, odd at the second stride-2 block
    for t, shards, match in ((300, 2, "not divisible"),
                             (304 * 4, 3, "not divisible by 3"),
                             (32, 4, "max_shift")):
        with pytest.raises(ValueError, match=match):
            seqpar.validate_time_sharding(full, t, shards, 8)
        with pytest.raises(ValueError, match=match):
            jax_seqpar.validate_time_sharding(jax_full, t, shards)
    seqpar.validate_time_sharding(full, 304, 2, 8)
    jax_seqpar.validate_time_sharding(jax_full, 304, 2)
    # the radius is the model's: 16 needs 17 local frames at every block
    small = config_from_reference_args(ARGS)
    seqpar.validate_time_sharding(small, 32, 2, 8)
    with pytest.raises(ValueError, match="max_shift"):
        seqpar.validate_time_sharding(small, 32, 2, 16)
    with pytest.raises(ValueError, match="max_shift"):
        jax_seqpar.validate_time_sharding(dataclasses.replace(
            jax_model.config_from_reference_args(ARGS),
            lowering=Lowering(max_shift=16)), 32, 2)
