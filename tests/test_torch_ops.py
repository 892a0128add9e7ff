"""Port ops (shift_gcn_torch.ops) vs the reference package's ops on the
CPU, same numpy inputs.  The Pallas kernels run in interpret mode; the
port's kernel wrappers take their plain PyTorch versions on CPU tensors."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shift_gcn_tpu.ops.batchnorm import batch_norm as jax_batch_norm
from shift_gcn_tpu.ops.conv import pointwise_conv as jax_pointwise_conv
from shift_gcn_tpu.ops.conv import temporal_conv as jax_temporal_conv
from shift_gcn_tpu.ops.spatial_shift import spatial_shift as jax_spatial_shift
from shift_gcn_torch import kernels
from shift_gcn_torch.ops import batchnorm, conv, spatial_shift
from shift_gcn_torch.ops import shift_gcn_kernel, temporal_shift

tsk = importlib.import_module(
    "shift_gcn_tpu.ops.pallas.temporal_shift_kernel")
sgk = importlib.import_module("shift_gcn_tpu.ops.pallas.shift_gcn_kernel")

# fp32 forward parity: same two products and one sum per element (K1) or
# the same fp32 contraction in another summation order (K4)
FP32_TOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(tsk, "_INTERPRET", True)
    monkeypatch.setattr(sgk, "_INTERPRET", True)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("t", [16, 32])
@pytest.mark.parametrize("c", [3, 8, 130])
def test_temporal_shift_matches_pallas(interpret, stride, t, c):
    rng = np.random.default_rng(t * 1000 + c * 10 + stride)
    x = rng.standard_normal((2, t, 5, c)).astype(np.float32)
    ypos = rng.uniform(-3, 3, c).astype(np.float32)
    ypos[0] = 1.0  # an integer shift
    want = np.asarray(tsk.temporal_shift_pallas(
        jnp.asarray(x), jnp.zeros(c), jnp.asarray(ypos), stride))
    got = temporal_shift.temporal_shift(
        torch.from_numpy(x), torch.from_numpy(ypos), stride)
    assert got.shape == (2, t // stride, 5, c)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL,
                               rtol=FP32_TOL)


def test_temporal_shift_reads_zero_outside():
    x = torch.arange(1.0, 7.0).reshape(1, 6, 1, 1)
    out = temporal_shift.temporal_shift(x, torch.tensor([-1.5]), 1)
    # lo=-2, f=0.5: out[t] = (x[t-2] + x[t-1]) / 2, zero before frame 0
    np.testing.assert_allclose(out.reshape(-1).numpy(),
                               [0.0, 0.5, 1.5, 2.5, 3.5, 4.5])
    out2 = temporal_shift.temporal_shift(x, torch.tensor([0.5]), 2)
    # stride 2: y = 1.0 -> out[t] = x[2t + 1], past the end reads zero
    np.testing.assert_allclose(out2.reshape(-1).numpy(), [2.0, 4.0, 6.0])


def test_temporal_shift_bf16_keeps_dtype():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 8, 3, 4)).astype(
        np.float32))
    ypos = torch.from_numpy(rng.uniform(-1, 1, 4).astype(np.float32))
    got = temporal_shift.temporal_shift(x.bfloat16(), ypos, 2)
    assert got.dtype == torch.bfloat16
    want = temporal_shift.temporal_shift(x.bfloat16().float(), ypos, 2)
    # one rounding of the fp32 result to bf16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("value", [7.5, -7.6, 9.0])
def test_assert_in_range_raises(value):
    with pytest.raises(ValueError, match="max_shift"):
        temporal_shift.assert_in_range(np.array([0.1, value]))


def test_assert_in_range_accepts_inside():
    temporal_shift.assert_in_range(np.array([7.49, -7.49]))
    temporal_shift.assert_in_range(torch.tensor([2.0]), max_shift=3)


@pytest.mark.parametrize("v", [25, 33])
@pytest.mark.parametrize("c,d", [(3, 8), (8, 16)])
def test_fused_shift_gcn_matches_pallas(interpret, v, c, d):
    rng = np.random.default_rng(v + c + d)
    x = rng.standard_normal((40, v, c)).astype(np.float32)
    gate = (np.tanh(rng.standard_normal((v, c))) + 1.0).astype(np.float32)
    w = rng.standard_normal((c, d)).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    want = np.asarray(sgk.fused_shift_gcn(
        jnp.asarray(x), jnp.asarray(gate), jnp.asarray(w), jnp.asarray(b),
        32))
    got = shift_gcn_kernel.fused_shift_gcn(*map(torch.from_numpy,
                                                (x, gate, w, b)))
    assert got.shape == (40, v, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL,
                               rtol=FP32_TOL)


@pytest.mark.parametrize("direction", [1, -1])
def test_spatial_shift_matches_reference(direction):
    x = np.random.default_rng(4).standard_normal((2, 33, 7)).astype(
        np.float32)
    want = np.asarray(jax_spatial_shift(jnp.asarray(x), direction, "gather"))
    got = spatial_shift.spatial_shift(torch.from_numpy(x), direction)
    np.testing.assert_array_equal(got.numpy(), want)


def test_flat_shift_index_is_the_shift():
    # the reference's flat index_select buffers encode the same rolls
    v, c = 5, 3
    x = np.random.default_rng(5).standard_normal((v, c)).astype(np.float32)
    for direction in (1, -1):
        flat = x.reshape(-1)[spatial_shift.flat_shift_index(v, c, direction)]
        want = spatial_shift.spatial_shift(torch.from_numpy(x), direction)
        np.testing.assert_array_equal(flat.reshape(v, c), want.numpy())


@pytest.mark.parametrize("feature_dims,reduce_axes,shape", [
    (1, (0, 1), (2, 6, 15)),         # data_bn: (N, T, M*V*C)
    (2, (0, 1), (2, 6, 5, 3)),       # Shift_gcn bn: (V, C) features
    (1, (0, 1, 2), (2, 6, 5, 3)),    # tcn / residual / down bn
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_eval_matches_reference(feature_dims, reduce_axes, shape,
                                           dtype):
    rng = np.random.default_rng(len(shape) + feature_dims)
    nf = int(np.prod(shape[len(shape) - feature_dims:]))
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.uniform(0.5, 1.5, nf).astype(np.float32)
    b = rng.standard_normal(nf).astype(np.float32)
    mean = rng.standard_normal(nf).astype(np.float32)
    var = rng.uniform(0.5, 2.0, nf).astype(np.float32)
    want, _ = jax_batch_norm(
        jnp.asarray(x).astype(dtype),
        {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
        {"running_mean": jnp.asarray(mean), "running_var": jnp.asarray(var),
         "num_batches_tracked": jnp.zeros((), jnp.int32)},
        reduce_axes=reduce_axes, training=False, lp=True)
    got = batchnorm.batch_norm(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        *map(torch.from_numpy, (w, b, mean, var)),
        feature_dims=feature_dims)
    # bf16: x*a + b in bf16 on both sides, but each framework may round
    # the product separately or not: up to one bf16 ulp of |x*a| <= 8
    atol, rtol = (FP32_TOL, FP32_TOL) if dtype == "float32" else (
        2 ** -5, 2 ** -7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


def test_conv_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 5, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6, 1, 1)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jax_pointwise_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = conv.pointwise_conv(*map(torch.from_numpy, (x, w, b)))
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL,
                               rtol=FP32_TOL)
    for k, stride in ((1, 2), (3, 1), (3, 2)):
        wk = rng.standard_normal((4, 6, k, 1)).astype(np.float32)
        want = np.asarray(jax_temporal_conv(
            jnp.asarray(x), jnp.asarray(wk), jnp.asarray(b), stride=stride))
        got = conv.temporal_conv(torch.from_numpy(x), torch.from_numpy(wk),
                                 torch.from_numpy(b), stride=stride)
        np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL,
                                   rtol=FP32_TOL)


def test_cpu_path_launches_no_kernel():
    kernels.reset_launches()
    x = torch.zeros(1, 4, 33, 3)
    temporal_shift.temporal_shift(x, torch.zeros(3), 2)
    shift_gcn_kernel.fused_shift_gcn(
        x.reshape(4, 33, 3), torch.ones(33, 3), torch.zeros(3, 5),
        torch.zeros(5))
    assert kernels.LAUNCHES == {"temporal_shift": 0, "shift_gcn": 0}


def test_kernel_build_targets_hopper():
    # every source is compiled for sm_90a, one library per source
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for name in kernels.SOURCES:
        assert (kernels.CSRC / f"{name}.cu").is_file()
        assert kernels._library_path(name).parent == kernels.BUILD_DIR
