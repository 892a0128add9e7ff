"""Port ops (shift_gcn_torch.ops) vs the reference package's ops on the
CPU, same numpy inputs.  The Pallas kernels run in interpret mode; the
port's kernel wrappers take their plain PyTorch versions on CPU tensors."""

import importlib

import numpy as np
import pytest
import torch

import jax
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


# (C, T, stride, |ypos| bound): every C in {3, 8, 130} at T in {16, 32} and
# both strides with shifts in U(-3, 3); then shifts out to +-7.4, inside
# the reference's tap radius (max_shift 8), with odd T at both strides
K1_PALLAS_CASES = [
    pytest.param(c, t, stride, 3.0, id=f"{c}-{t}-{stride}")
    for c in (3, 8, 130) for t in (16, 32) for stride in (1, 2)] + [
    pytest.param(c, t, stride, 7.4, id=f"far-{c}-{t}-{stride}")
    for c, t, stride in ((3, 17, 1), (130, 16, 1), (3, 17, 2), (130, 17, 2),
                         (130, 33, 2))]


@pytest.mark.parametrize("c,t,stride,spread", K1_PALLAS_CASES)
def test_temporal_shift_matches_pallas(interpret, c, t, stride, spread):
    rng = np.random.default_rng(t * 1000 + c * 10 + stride)
    x = rng.standard_normal((2, t, 5, c)).astype(np.float32)
    ypos = rng.uniform(-spread, spread, c).astype(np.float32)
    ypos[0] = 1.0  # an integer shift
    if spread > 3:  # both ends of the range, and a whole shift near one
        ypos[1:4] = (7.4, -7.4, -7.0)[:c - 1]
    want = np.asarray(tsk.temporal_shift_pallas(
        jnp.asarray(x), jnp.zeros(c), jnp.asarray(ypos), stride))
    got = temporal_shift.temporal_shift(
        torch.from_numpy(x), torch.from_numpy(ypos), stride)
    assert got.shape == (2, t // stride, 5, c)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_TOL,
                               rtol=FP32_TOL)


def _shift_float64(x, ypos, stride):
    """K1's formula in float64 from the fp32 position y = ypos (+0.5 at
    stride 2), as every implementation forms it."""
    n, t_in, v, c = x.shape
    out = np.zeros((n, t_in // stride, v, c))
    for ch in range(c):
        y = np.float64(np.float32(ypos[ch]) + np.float32(
            0.5 if stride != 1 else 0.0))
        lo = int(np.floor(y))
        f = y - lo
        for t in range(t_in // stride):
            k = t * stride + lo
            a = x[:, k, :, ch] if 0 <= k < t_in else 0.0
            b = x[:, k + 1, :, ch] if 0 <= k + 1 < t_in else 0.0
            out[:, t, :, ch] = (1 - f) * a + f * b
    return out


@pytest.mark.parametrize("stride,t", [(1, 9), (1, 16), (2, 9), (2, 16)])
def test_temporal_shift_plain_matches_float64(stride, t):
    # the plain version the card's kernel is held to, against the formula
    # in float64, at shifts inside and far outside the clip; where every
    # tap falls outside [0, T) the output is exactly zero
    rng = np.random.default_rng(60 + 10 * t + stride)
    outside = [20.3, -20.3, t + 0.5, -(t + 1.5)]
    ypos = np.concatenate([rng.uniform(-3, 3, 6), [0.0, 2.0, -0.5],
                           outside]).astype(np.float32)
    x = rng.standard_normal((2, t, 3, ypos.size)).astype(np.float32)
    got = temporal_shift.temporal_shift_reference(
        torch.from_numpy(x), torch.from_numpy(ypos), stride).numpy()
    want = _shift_float64(x.astype(np.float64), ypos, stride)
    # one rounding of each product and of the sum, |x| < 6
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-6)
    assert not got[..., -len(outside):].any()
    assert want[..., :-len(outside)].any()


def test_temporal_shift_reads_zero_outside():
    x = torch.arange(1.0, 7.0).reshape(1, 6, 1, 1)
    out = temporal_shift.temporal_shift(x, torch.tensor([-1.5]), 1)
    # lo=-2, f=0.5: out[t] = (x[t-2] + x[t-1]) / 2, zero before frame 0
    np.testing.assert_allclose(out.reshape(-1).numpy(),
                               [0.0, 0.5, 1.5, 2.5, 3.5, 4.5])
    out2 = temporal_shift.temporal_shift(x, torch.tensor([0.5]), 2)
    # stride 2: y = 1.0 -> out[t] = x[2t + 1], past the end reads zero
    np.testing.assert_allclose(out2.reshape(-1).numpy(), [2.0, 4.0, 6.0])


@pytest.mark.parametrize("stride", [1, 2])
def test_temporal_shift_bf16_keeps_dtype(stride):
    # bf16 in and out: the fp32 result on the same values, rounded once to
    # bf16, bit for bit (what the card's kernel is held to)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 8, 3, 4)).astype(
        np.float32))
    ypos = torch.from_numpy(rng.uniform(-1, 1, 4).astype(np.float32))
    got = temporal_shift.temporal_shift(x.bfloat16(), ypos, stride)
    assert got.dtype == torch.bfloat16
    want = temporal_shift.temporal_shift(x.bfloat16().float(), ypos, stride)
    assert torch.equal(got, want.bfloat16())


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
    x = torch.zeros(1, 4, 33, 3, requires_grad=True)
    ypos = torch.zeros(3, requires_grad=True)
    temporal_shift.temporal_shift(x, ypos, 2).sum().backward()
    w = torch.zeros(3, 5, requires_grad=True)
    shift_gcn_kernel.fused_shift_gcn(
        x.reshape(4, 33, 3), torch.ones(33, 3), w, torch.zeros(5)
    ).sum().backward()
    batchnorm.BatchNorm(3).train()(x).square().sum().backward()
    assert set(kernels.LAUNCHES) == set(kernels.KERNELS)
    # K6 is one weight-gradient kernel; the bare shear is gone
    assert "shift_gcn_wgrad" in kernels.LAUNCHES
    assert "shear_in" not in kernels.LAUNCHES
    # K2 and K3 count as one fused kernel
    assert "temporal_shift_backward" in kernels.LAUNCHES
    assert not {"temporal_shift_grad_input",
                "temporal_shift_position_grad"} & set(kernels.LAUNCHES)
    # a train-mode BN counts one forward and one backward launch
    assert {"batch_norm_train", "batch_norm_train_backward"} <= set(
        kernels.LAUNCHES)
    assert all(count == 0 for count in kernels.LAUNCHES.values())


def test_kernel_build_targets_hopper():
    # every source is compiled for sm_90a, one library per source
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for name in kernels.SOURCES:
        assert (kernels.CSRC / f"{name}.cu").is_file()
        assert kernels._library_path(name).parent == kernels.BUILD_DIR
    assert set(kernels.KERNELS.values()) == set(kernels.SOURCES)


# ---------------------------------------------------------------------------
# K1's tile (csrc/temporal_shift.cu tshift_forward_kernel), emulated
# ---------------------------------------------------------------------------


def _rotated_word(word, q, stride):
    """Where word `word` of a staged fp32 slab row of window frame q lies
    (the kernel's rotated_word)."""
    return (word & ~3) | ((word + (q >> (stride - 1))) & 3)


def _emulate_forward(x, ypos, stride, cs, run_in, w, rotated):
    """The forward kernel's arithmetic in numpy float32: tiles of (clip,
    run_in // stride output frames, slab of cs channels) stage at most w
    frames of the slab (rows rotated where `rotated`) beside a zero frame;
    a tap reads the window, the zero frame (outside [0, T)) or, outside
    the window, x; the products and the sum are rounded separately.
    Window slots never staged hold NaN, so a read of one shows."""
    n, t_in, v, c = x.shape
    t_out = t_in // stride
    run = run_in // stride
    f32 = np.float32
    out = np.zeros((n, t_out, v, c), f32)
    for c0 in range(0, c, cs):
        chans = range(c0, min(c0 + cs, c))
        lo, frac = {}, {}
        for ch in chans:
            y = f32(ypos[ch]) + f32(0.5 if stride != 1 else 0.0)
            lo_f = np.floor(y)
            frac[ch] = f32(y - lo_f)
            lo[ch] = min(max(int(lo_f), -(t_out * stride + 1)), t_in + 1)
        lo_min, lo_max = min(lo.values()), max(lo.values())

        def place(slot, q):
            return _rotated_word(slot, q, stride) if rotated else slot

        for nn in range(n):
            for t0 in range(0, t_out, run):
                t_last = min(t0 + run, t_out) - 1
                w0 = max(t0 * stride + lo_min, 0)
                nq = max(0, min(min(t_last * stride + lo_max + 1, t_in - 1)
                                - w0 + 1, w))
                win = np.full((w + 1, v, cs), np.nan, f32)
                win[w] = 0.0
                for q in range(nq):
                    for ch in chans:
                        win[q, :, place(ch - c0, q)] = x[nn, w0 + q, :, ch]

                def tap(k, ch):
                    if k < 0 or k >= t_in:
                        return win[w, :, ch - c0]
                    if 0 <= k - w0 < nq:
                        return win[k - w0, :, place(ch - c0, k - w0)]
                    return x[nn, k, :, ch]

                for t in range(t0, t_last + 1):
                    for ch in chans:
                        k = t * stride + lo[ch]
                        out[nn, t, :, ch] = ((f32(1.0) - frac[ch])
                                             * tap(k, ch)
                                             + frac[ch] * tap(k + 1, ch))
    return out


# the kernel's tile shapes: (slab channels, input frames a run, rotated)
K1_TILES = {"fp32": (32, 16, True), "fp32 1-lane": (8, 16, False),
            "bf16": (64, 8, False)}


@pytest.mark.parametrize("window", ["holds the taps", "4 frames", "1 frame"])
@pytest.mark.parametrize("tile", list(K1_TILES))
@pytest.mark.parametrize("stride", [1, 2])
def test_forward_tile_emulation_matches_plain(stride, tile, window):
    # the staged window, its rotation, the zero frame and the walk through
    # device memory for taps outside the window give the plain version's
    # result bit for bit, at any window size: 40 channels are a full
    # 32-channel slab and a partial one, T=19 is odd, some shifts leave
    # the clip
    cs, run_in, rotated = K1_TILES[tile]
    rng = np.random.default_rng(17 + stride)
    ypos = rng.uniform(-2.5, 2.5, 40).astype(np.float32)
    ypos[:5] = (20.3, -20.3, 7.4, -7.4, 1.0)
    x = rng.standard_normal((2, 19, 3, 40)).astype(np.float32)
    if tile == "bf16":  # values a bf16 tensor holds
        x = torch.from_numpy(x).bfloat16().float().numpy()
    w = {"holds the taps": 40, "4 frames": 4, "1 frame": 1}[window]
    got = _emulate_forward(x, ypos, stride, cs, run_in, w, rotated)
    xt = torch.from_numpy(x)
    if tile == "bf16":
        want = temporal_shift.temporal_shift_reference(
            xt.bfloat16(), torch.from_numpy(ypos), stride)
        assert torch.equal(torch.from_numpy(got).bfloat16(), want)
    else:
        want = temporal_shift.temporal_shift_reference(
            xt, torch.from_numpy(ypos), stride)
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("stride", [1, 2])
def test_rotated_rows_spread_banks(stride):
    # a warp of the fp32 tile is 8 four-channel lanes x 4 output frames,
    # each lane reading its channels one at a time from the window (frames
    # of 33 rows of 32 words and an 8-word pad).  Staged as they lie,
    # channel i of every lane sits in the 8 banks = i mod 4, a 4-way
    # conflict; rotated by frame, the warp's 32 reads hit 32 banks
    fs = 33 * 32 + 8
    for joint in (0, 5):
        for i in range(4):
            for tap in (0, 1):
                rotated, flat = set(), set()
                for lane in range(32):
                    cv, f = lane % 8, lane // 8
                    q = f * stride + tap  # window frame, lo alike
                    row = q * fs + joint * 32
                    rotated.add(
                        (row + _rotated_word(cv * 4 + i, q, stride)) % 32)
                    flat.add((row + cv * 4 + i) % 32)
                assert len(rotated) == 32
                assert len(flat) == 8


# ---------------------------------------------------------------------------
# Backward: K2/K3 (temporal shift) and K5/K6 (fused Shift-GCN)
# ---------------------------------------------------------------------------


def _torch_params(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


# (stride, T, C): each (stride, T) pair of T in {16, 17, 32} meets every C
# in {3, 8, 130}; T=17 at stride 2 drops its odd last frame
@pytest.mark.parametrize("stride,t,c", [
    (1, 16, 3), (1, 17, 130), (1, 32, 8),
    (2, 16, 8), (2, 17, 3), (2, 32, 130)])
def test_temporal_shift_grads_match_pallas(interpret, stride, t, c):
    rng = np.random.default_rng(100 * t + c + stride)
    x = rng.standard_normal((2, t, 5, c)).astype(np.float32)
    ypos = rng.uniform(-3, 3, c).astype(np.float32)
    ypos[:2] = (1.0, -2.0)  # integer shifts: f = 0
    xpos = rng.uniform(-1e-8, 1e-8, c).astype(np.float32)
    g = rng.standard_normal((2, t // stride, 5, c)).astype(np.float32)

    def loss(x_, xp_, yp_):
        return jnp.sum(tsk.temporal_shift_pallas(x_, xp_, yp_, stride) * g)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(x), jnp.asarray(xpos), jnp.asarray(ypos))
    xt, xpt, ypt = _torch_params(x, xpos, ypos)
    out = temporal_shift.temporal_shift(xt, ypt, stride, xpos=xpt)
    out.backward(torch.from_numpy(g))
    # the reference reaches grad_input through floor(-y), one rounding of
    # (1 - f) away from the exact transpose: fp32 roundoff
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]),
                               atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_array_equal(xpt.grad.numpy(), np.zeros(c, np.float32))
    # constraint steps are exactly +-0.01 or 1e-4: bit-equal
    np.testing.assert_array_equal(ypt.grad.numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("stride,t,c", [
    (1, 16, 3), (1, 17, 130), (1, 32, 8),
    (2, 16, 8), (2, 17, 3), (2, 32, 130)])
def test_fused_temporal_shift_backward_matches_pallas(interpret, monkeypatch,
                                                      stride, t, c):
    # the fused launcher returns exactly what K2's and K3's plain versions
    # give, and the Function reaches both gradients through that one call
    rng = np.random.default_rng(200 * t + c + stride)
    x = rng.standard_normal((2, t, 5, c)).astype(np.float32)
    ypos = rng.uniform(-3, 3, c).astype(np.float32)
    ypos[:2] = (2.0, -1.0)  # integer shifts: f = 0
    g = rng.standard_normal((2, t // stride, 5, c)).astype(np.float32)
    xt, yt, gt = map(torch.from_numpy, (x, ypos, g))
    dx, gy_raw = temporal_shift.temporal_shift_backward(xt, gt, yt, stride)
    assert dx.shape == xt.shape and gy_raw.dtype == torch.float32
    np.testing.assert_array_equal(
        dx.numpy(), temporal_shift.temporal_shift_grad_input_reference(
            gt, yt, stride, t).numpy())
    np.testing.assert_array_equal(
        gy_raw.numpy(), temporal_shift.temporal_shift_position_grad_reference(
            xt, gt, yt, stride).numpy())

    def loss(x_, yp_):
        return jnp.sum(tsk.temporal_shift_pallas(
            x_, jnp.zeros(c), yp_, stride) * g)

    want = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x),
                                                   jnp.asarray(ypos))
    calls = []
    fused = temporal_shift.temporal_shift_backward
    monkeypatch.setattr(temporal_shift, "temporal_shift_backward",
                        lambda *a: calls.append(a) or fused(*a))
    for name in ("temporal_shift_grad_input", "temporal_shift_position_grad"):
        monkeypatch.setattr(temporal_shift, name, None)
    xg, yg = _torch_params(x, ypos)
    temporal_shift.temporal_shift(xg, yg, stride).backward(gt)
    assert len(calls) == 1
    np.testing.assert_allclose(xg.grad.numpy(), np.asarray(want[0]),
                               atol=FP32_TOL, rtol=FP32_TOL)
    np.testing.assert_array_equal(yg.grad.numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("needs", ["x", "ypos"])
def test_temporal_shift_backward_one_output(monkeypatch, needs):
    # with one gradient wanted, the Function makes that output's call only
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((2, 8, 3, 4)).astype(
        np.float32)).requires_grad_(needs == "x")
    ypos = torch.tensor([0.3, -1.2, 2.0, 0.7], requires_grad=needs == "ypos")
    g = torch.from_numpy(rng.standard_normal((2, 4, 3, 4)).astype(
        np.float32))
    monkeypatch.setattr(temporal_shift, "temporal_shift_backward", None)
    temporal_shift.temporal_shift(x, ypos, 2).backward(g)
    if needs == "x":
        np.testing.assert_array_equal(
            x.grad.numpy(), temporal_shift.temporal_shift_grad_input_reference(
                g, ypos.detach(), 2, 8).numpy())
        assert ypos.grad is None
    else:
        np.testing.assert_array_equal(
            ypos.grad.numpy(), temporal_shift.constraint_step(
                temporal_shift.temporal_shift_position_grad_reference(
                    x, g, ypos.detach(), 2)).numpy())
        assert x.grad is None


def _gy_raw_output_frames(x, g, ypos, stride):
    """gy_raw in float64 as the reference sums it: over output frames t,
    (x[t*s + lo + 1] - x[t*s + lo]) * g[t], zero outside [0, T)."""
    n, t_in = x.shape[:2]
    want = np.zeros(x.shape[-1], np.float64)
    for c, y in enumerate(ypos):
        lo = int(np.floor(np.float32(y) + np.float32(0.5 if stride != 1
                                                     else 0.0)))
        for tt in range(g.shape[1]):
            t0 = tt * stride + lo
            x1 = x[:, t0 + 1, :, c] if 0 <= t0 + 1 < t_in else 0.0
            x0 = x[:, t0, :, c] if 0 <= t0 < t_in else 0.0
            want[c] += np.sum((x1 - x0) * g[:, tt, :, c]) / n
    return want


@pytest.mark.parametrize("stride,t", [(1, 9), (1, 16), (2, 9), (2, 16)])
def test_gy_raw_reindexed_over_input_frames(stride, t):
    # the identity the fused kernel rests on: summed over input frames k,
    # gy_raw = (1/N) sum x[k] * (b - a) with a = g[(k - lo) / s] and
    # b = g[(k - lo - 1) / s], each zero unless its offset is a
    # non-negative multiple of s below T_out * s
    rng = np.random.default_rng(40 + 10 * t + stride)
    ypos = np.array([0.0, 3.0, -2.0, 7.4, -7.4, 0.35, -0.8, 20.3, -20.3,
                     t + 0.5, -(t + 1.5)], np.float32)
    c = ypos.size
    x = rng.standard_normal((3, t, 2, c))
    g = rng.standard_normal((3, t // stride, 2, c))
    t_out = t // stride
    got = np.zeros(c, np.float64)
    for ch, y in enumerate(ypos):
        lo = int(np.floor(np.float32(y) + np.float32(0.5 if stride != 1
                                                     else 0.0)))

        def tap(kk):
            ok = 0 <= kk < t_out * stride and kk % stride == 0
            return g[:, kk // stride, :, ch] if ok else 0.0

        for k in range(t):
            a, b = tap(k - lo), tap(k - lo - 1)
            got[ch] += np.sum(x[:, k, :, ch] * (b - a)) / 3
    want = _gy_raw_output_frames(x, g, ypos, stride)
    np.testing.assert_allclose(got, want, atol=1e-12)
    plain = temporal_shift.temporal_shift_position_grad_reference(
        torch.from_numpy(x).float(), torch.from_numpy(g).float(),
        torch.from_numpy(ypos), stride)
    np.testing.assert_allclose(plain.numpy(), got, atol=1e-5)
    # shifts past both ends of the clip read nothing
    assert got[-4:].tolist() == [0.0] * 4


def test_cpu_temporal_shift_gives_constraint_step():
    # on the CPU the plain version runs inside the Function: ypos gets the
    # reference's fixed step, not the derivative plain autograd would give
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 4, 6)).astype(np.float32)
    ypos = rng.uniform(-2, 2, 6).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((2, 12, 4, 6)).astype(
        np.float32))
    yt = torch.from_numpy(ypos).requires_grad_()
    temporal_shift.temporal_shift(torch.from_numpy(x), yt, 1).backward(g)
    true_y = torch.from_numpy(ypos).requires_grad_()
    frac, x0, x1 = temporal_shift._source_frames(
        torch.from_numpy(x), true_y, 1)
    ((1.0 - frac) * x0 + frac * x1).backward(g)
    step = yt.grad.numpy()
    assert set(np.abs(step).tolist()) <= {np.float32(0.01), np.float32(1e-4)}
    np.testing.assert_array_equal(
        np.sign(step), np.sign(true_y.grad.numpy()))
    assert not np.allclose(step, true_y.grad.numpy())


def test_constraint_step_values():
    raw = torch.tensor([3.0, -1e-30, 0.0, -0.0, 7e-8])
    np.testing.assert_array_equal(
        temporal_shift.constraint_step(raw).numpy(),
        np.array([0.01, -0.01, 1e-4, 1e-4, 0.01], np.float32))


@pytest.mark.parametrize("stride,t", [(1, 9), (2, 9), (2, 10)])
def test_temporal_shift_plain_backward_is_transpose(stride, t):
    # K2's plain version is the exact transpose of K1's; K3's is the mean
    # over N, sum over (T, V) of the two-tap difference times g
    rng = np.random.default_rng(t + stride)
    x = torch.from_numpy(rng.standard_normal((3, t, 2, 5)).astype(
        np.float32)).requires_grad_()
    ypos = torch.tensor([0.0, 1.5, -2.25, 3.0, -0.75])
    g = torch.from_numpy(rng.standard_normal((3, t // stride, 2, 5)).astype(
        np.float32))
    frac, x0, x1 = temporal_shift._source_frames(x, ypos, stride)
    ((1.0 - frac) * x0 + frac * x1).backward(g)
    got = temporal_shift.temporal_shift_grad_input_reference(
        g, ypos, stride, t)
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), atol=1e-6)
    want = _gy_raw_output_frames(x.detach().numpy(), g.numpy(),
                                 ypos.numpy(), stride)
    got = temporal_shift.temporal_shift_position_grad_reference(
        x.detach(), g, ypos, stride)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("v", [25, 33])
@pytest.mark.parametrize("c,d", [(3, 8), (8, 16), (16, 8)])
def test_fused_shift_gcn_grads_match_pallas(interpret, v, c, d):
    rng = np.random.default_rng(7 * v + c + d)
    x = rng.standard_normal((40, v, c)).astype(np.float32)
    mask = rng.standard_normal((v, c)).astype(np.float32)
    w = rng.standard_normal((c, d)).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    g = rng.standard_normal((40, v, d)).astype(np.float32)

    def loss(x_, m_, w_, b_):
        return jnp.sum(sgk.fused_shift_gcn(x_, jnp.tanh(m_) + 1.0, w_, b_,
                                           32) * g)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (x, mask, w, b)))
    params = _torch_params(x, mask, w, b)
    xt, mt, wt, bt = params
    out = shift_gcn_kernel.fused_shift_gcn(xt, torch.tanh(mt) + 1.0, wt, bt)
    out.backward(torch.from_numpy(g))
    # fp32: dw and dgate sum over R*V = 1320 products in another order (and
    # the reference takes dgate through h / gate): 1e-5 of each
    # gradient's scale
    for name, p, ref in zip(("dx", "dmask", "dw", "dbias"), params, want):
        ref = np.asarray(ref)
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=1e-5 * scale,
                                   rtol=1e-5, err_msg=name)


def test_dx_skipped_when_input_needs_no_grad():
    # x needs no grad: the backward runs no dx at all
    x = torch.randn(6, 5, 3)
    w = torch.randn(3, 4, requires_grad=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(shift_gcn_kernel, "shift_gcn_dx", None)
        shift_gcn_kernel.fused_shift_gcn(
            x, torch.ones(5, 3), w, torch.zeros(4)).sum().backward()
    assert w.grad is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shift_gcn_plain_backward(dtype):
    # K5's plain version is autograd's dx of the plain forward, K6's its
    # (dgate, dw, dbias); the shear K6 applies as it loads is shift_in(x)
    # widened to fp32
    rng = np.random.default_rng(12)
    x, gate, w, b = _torch_params(
        rng.standard_normal((4, 7, 3)).astype(np.float32),
        rng.uniform(0.5, 1.5, (7, 3)).astype(np.float32),
        rng.standard_normal((3, 5)).astype(np.float32),
        np.zeros(5, np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 7, 5)).astype(np.float32))
    spatial_shift.shift_gcn_transform(x, gate, w, b).backward(g)
    np.testing.assert_allclose(
        spatial_shift.shift_gcn_dx_reference(g, gate.detach(),
                                             w.detach()).numpy(),
        x.grad.numpy(), atol=1e-6)
    got = spatial_shift.shift_gcn_wgrad_reference(
        x.detach().to(dtype), g.to(dtype), gate.detach(), w.detach())
    want = [p.grad for p in (gate, w, b)]
    if dtype == torch.bfloat16:  # autograd of the plain forward on bf16 x, g
        xb, gb = x.detach().to(dtype).float(), g.to(dtype).float()
        ps = _torch_params(gate.detach().numpy(), w.detach().numpy(),
                           np.zeros(5, np.float32))
        spatial_shift.shift_gcn_transform(xb, *ps).backward(gb)
        want = [p.grad for p in ps]
    for name, a, ref in zip(("dgate", "dw", "dbias"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), ref.numpy(), atol=1e-5,
                                   err_msg=name)
    got = spatial_shift.shear_in_reference(x.detach().to(dtype))
    want = jax_spatial_shift(jnp.asarray(x.detach().to(dtype).float().numpy()),
                             1, "gather")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("launcher", [
    lambda x: temporal_shift.temporal_shift_forward(x, torch.zeros(3), 1),
    lambda x: temporal_shift.temporal_shift_grad_input(
        x, torch.zeros(3), 1, 4),
    lambda x: temporal_shift.temporal_shift_position_grad(
        x, x.detach(), torch.zeros(3), 1),
    lambda x: temporal_shift.temporal_shift_backward(
        x, x.detach(), torch.zeros(3), 1),
    lambda x: shift_gcn_kernel.shift_gcn_forward(
        x[0], torch.ones(4, 3), torch.zeros(3, 2), torch.zeros(2)),
    lambda x: shift_gcn_kernel.shift_gcn_dx(
        x[0], torch.ones(4, 3), torch.zeros(3, 3)),
    lambda x: shift_gcn_kernel.shift_gcn_wgrad(
        x[0], x[0].detach(), torch.ones(4, 3), torch.zeros(3, 3)),
    lambda x: batchnorm.batch_norm_train_forward(
        x, torch.ones(3), torch.zeros(3), torch.zeros(3), torch.ones(3),
        torch.zeros((), dtype=torch.long)),
    lambda x: batchnorm.batch_norm_train_backward(
        x, x.detach(), torch.stack([torch.zeros(3), torch.ones(3)]),
        torch.ones(3)),
], ids=["K1", "K2", "K3", "K2K3", "K4", "K5", "K6", "BN", "BN_backward"])
def test_raw_launchers_refuse_grad(launcher):
    # a raw launcher's output has no grad_fn: outside its Function, in
    # grad mode, it raises instead of cutting the gradient
    x = torch.zeros(1, 4, 4, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        launcher(x)
    with torch.no_grad():
        launcher(x)


@pytest.mark.parametrize("feature_dims,reduce_axes,shape", [
    (1, (0, 1), (3, 6, 15)),         # data_bn: (N, T, M*V*C)
    (2, (0, 1), (3, 6, 5, 3)),       # Shift_gcn bn: (V, C) features
    (1, (0, 1, 2), (3, 6, 5, 3)),    # tcn / residual / down bn
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_train_matches_reference(feature_dims, reduce_axes,
                                            shape, dtype):
    rng = np.random.default_rng(20 + len(shape) + feature_dims)
    nf = int(np.prod(shape[len(shape) - feature_dims:]))
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, nf).astype(np.float32)
    b = rng.standard_normal(nf).astype(np.float32)
    mean = rng.standard_normal(nf).astype(np.float32)
    var = rng.uniform(0.5, 2.0, nf).astype(np.float32)
    want, new_state = jax_batch_norm(
        jnp.asarray(x).astype(dtype),
        {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
        {"running_mean": jnp.asarray(mean), "running_var": jnp.asarray(var),
         "num_batches_tracked": jnp.asarray(4, jnp.int32)},
        reduce_axes=reduce_axes, training=True, lp=False)
    bn = batchnorm.BatchNorm(nf, feature_dims=feature_dims)
    with torch.no_grad():
        for name, value in (("weight", w), ("bias", b),
                            ("running_mean", mean), ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(value))
        bn.num_batches_tracked.fill_(4)
    got = bn.train()(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # fp32 stats and normalize on both sides; bf16 differs by the final
    # rounding only (both round the same fp32 value, up to roundoff)
    tol = FP32_TOL if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    for key in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, key).numpy(),
                                   np.asarray(new_state[key]),
                                   atol=FP32_TOL, rtol=FP32_TOL)
    assert int(bn.num_batches_tracked) == int(
        new_state["num_batches_tracked"]) == 5


# ---------------------------------------------------------------------------
# Train-mode BN: the Function's plain version, its analytic backward, and
# the kernels' launch plan (csrc/batchnorm.cu)
# ---------------------------------------------------------------------------


def _batch_norm_train_composition(x, weight, bias, feature_dims, lp):
    """Train-mode BN as the port wrote it before its Function: stock ops
    that autograd differentiates one by one.  The analytic backward's
    oracle."""
    dims = tuple(range(x.dim() - feature_dims))
    shape = x.shape[x.dim() - feature_dims:]
    x32 = x.to(batchnorm.stat_dtype(x.dtype))
    stats = torch.stack([x32.mean(dims), (x32 * x32).mean(dims)])
    mean, mean_sq = stats.unbind(0)
    inv = torch.rsqrt(mean_sq - mean * mean + 1e-5)
    return batchnorm._normalize(x, mean, inv, weight, bias, shape, lp, x32)


BN_LAYOUTS = [
    pytest.param(1, (0, 1), (3, 6, 15), id="data_bn"),   # (N, T, M*V*C)
    pytest.param(2, (0, 1), (3, 6, 5, 3), id="gcn_bn"),  # (V, C) features
    pytest.param(1, (0, 1, 2), (3, 6, 5, 3), id="tcn_bn"),
]


@pytest.mark.parametrize("feature_dims,reduce_axes,shape", BN_LAYOUTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lp", [False, True], ids=["fp32_normalize", "lp"])
@pytest.mark.parametrize("update", [True, False], ids=["update", "frozen"])
def test_batch_norm_train_function_matches_reference(
        feature_dims, reduce_axes, shape, dtype, lp, update):
    rng = np.random.default_rng(
        40 + len(shape) + feature_dims + 2 * lp + 4 * update)
    nf = int(np.prod(shape[len(shape) - feature_dims:]))
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, nf).astype(np.float32)
    b = rng.standard_normal(nf).astype(np.float32)
    mean = rng.standard_normal(nf).astype(np.float32)
    var = rng.uniform(0.5, 2.0, nf).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    want, new_state = jax_batch_norm(
        jnp.asarray(x).astype(dtype),
        {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
        {"running_mean": jnp.asarray(mean), "running_var": jnp.asarray(var),
         "num_batches_tracked": jnp.asarray(4, jnp.int32)},
        reduce_axes=reduce_axes, training=True, lp=lp)
    torch_dtype = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(torch_dtype).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
    nbt = torch.full((), 4, dtype=torch.long)
    kernels.reset_launches()
    got = batchnorm.batch_norm_train(xt, wt, bt, rm, rv, nbt,
                                     feature_dims=feature_dims, lp=lp,
                                     update=update)
    assert got.dtype == torch_dtype
    want32 = np.asarray(want.astype(jnp.float32))
    # fp32: the same fp32 statistics and normalize; bf16: one rounding of
    # the same fp32 value (or, lp, x * a + b in bf16, where XLA may keep
    # the product in fp32 before the add), a bf16 ulp of the scale apart
    atol = FP32_TOL if dtype == "float32" else 2 ** -7 * np.abs(want32).max()
    np.testing.assert_allclose(got.detach().float().numpy(), want32,
                               atol=atol, rtol=FP32_TOL)
    if update:
        for key, t in (("running_mean", rm), ("running_var", rv)):
            np.testing.assert_allclose(t.numpy(), np.asarray(new_state[key]),
                                       atol=FP32_TOL, rtol=FP32_TOL)
        assert int(nbt) == int(new_state["num_batches_tracked"]) == 5
    else:
        np.testing.assert_array_equal(rm.numpy(), mean)
        np.testing.assert_array_equal(rv.numpy(), var)
        assert int(nbt) == 4

    gt = torch.from_numpy(cot).to(torch_dtype)
    grads = torch.autograd.grad(got, (xt, wt, bt), gt)
    oracle = torch.autograd.grad(
        _batch_norm_train_composition(xt, wt, bt, feature_dims, lp),
        (xt, wt, bt), gt)
    # fp32: roundoff of two formulas of one gradient.  bf16: dx one
    # rounding to bf16 of fp32 values that differ by roundoff; dw and db
    # sums of the same fp32 terms.  lp: the oracle differentiates bf16
    # ops, each product and sum rounded to bf16 (2^-8 of its terms), a
    # few in a chain
    for name, g, o in zip(("dx", "dw", "db"), grads, oracle):
        tol = (2 ** -5 if dtype == "bfloat16" and lp
               else 2 ** -7 if dtype == "bfloat16" and name == "dx"
               else FP32_TOL)
        assert g.dtype == o.dtype, name
        o = o.float().numpy()
        np.testing.assert_allclose(g.float().numpy(), o, rtol=0,
                                   atol=tol * np.abs(o).max(), err_msg=name)
    # the plain versions on the CPU launch no kernel
    assert not any(kernels.LAUNCHES.values())


def test_batch_norm_train_backward_skips_dx():
    # data_bn's input (the clips) needs no gradient: dx is not computed,
    # dw and db are the ones a differentiable input gets
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 5, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, 5, 6)).astype(np.float32))
    grads = []
    for needs in (False, True):
        xi = x.clone().requires_grad_(needs)
        w, b = torch.ones(6, requires_grad=True), torch.zeros(
            6, requires_grad=True)
        y = batchnorm.batch_norm_train(
            xi, w, b, torch.zeros(6), torch.ones(6),
            torch.zeros((), dtype=torch.long))
        y.backward(g)
        assert (xi.grad is not None) == needs
        grads.append((w.grad, b.grad))
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    _, mean_inv = batchnorm.batch_norm_train_forward(
        x, torch.ones(6), torch.zeros(6), torch.zeros(6), torch.ones(6),
        torch.zeros((), dtype=torch.long), update=False)
    dx, dw, db = batchnorm.batch_norm_train_backward(
        x, g, mean_inv, torch.ones(6), want_dx=False)
    assert dx is None and dw.shape == db.shape == (6,)


def _emulate_bn_sums(a: np.ndarray, plan) -> np.ndarray:
    """The two per-feature sums of the kernels' reductions over a (R, F)
    fp32 array, in their order: each thread (feature, row lane) adds its
    chunk's rows one by one, the block its row lanes in order, then
    chunk lane q of the final pass chunks q, q + 32, ... and lane 0 the
    lanes in order.  Returns (2, F) fp32; raises unless the plan's tiles
    and chunks cover every element exactly once."""
    r, f = a.shape
    rlanes = batchnorm.PASS_THREADS // plan.lanes
    features = np.concatenate([
        (t * plan.lanes + lane) * plan.vec + np.arange(plan.vec)
        for t in range(plan.tiles) for lane in range(plan.lanes)])
    features = features[features < f]
    assert np.array_equal(np.sort(features), np.arange(f))
    seen = np.zeros(r, np.int64)
    partial = np.zeros((plan.chunks, 2, f), np.float32)
    for c in range(plan.chunks):
        rows = np.arange(c * plan.chunk_rows,
                         min(r, (c + 1) * plan.chunk_rows))
        assert rows.size, "an empty chunk"
        seen[rows] += 1
        pad = -rows.size % rlanes
        block = np.concatenate([a[rows], np.zeros((pad, f), np.float32)])
        block = block.reshape(-1, rlanes, f)    # (row step, row lane, F)
        for k, terms in enumerate((block, block * block)):
            per_thread = np.add.accumulate(terms, axis=0, dtype=np.float32)
            partial[c, k] = np.add.accumulate(per_thread[-1], axis=0,
                                              dtype=np.float32)[-1]
    assert (seen == 1).all()
    lanes = [np.add.accumulate(partial[q::32], axis=0, dtype=np.float32)[-1]
             for q in range(min(32, plan.chunks))]
    return np.add.accumulate(np.stack(lanes), axis=0, dtype=np.float32)[-1]


# (R, F, itemsize, aligned): the fall step's BN shapes at 2 clips (tcn BN
# C=64 and 256 in bf16, the Shift_gcn bn V*C=2112 and 8448, data_bn 99 in
# fp32), NTU's data_bn (150), an unaligned tensor, and edge cases: one row
# lane's worth of rows, and R smaller than a block's row lanes
BN_PLAN_CASES = [(2 * 300 * 33, 64, 2, True), (2 * 75 * 33, 256, 2, True),
                 (2 * 300, 2112, 2, True), (2 * 75, 8448, 2, True),
                 (2 * 300, 99, 4, True), (4 * 300, 150, 4, True),
                 (2 * 150 * 33, 128, 4, False), (8, 64, 4, True),
                 (3, 5, 2, True), (1, 8448, 4, True)]


@pytest.mark.parametrize("r,f,itemsize,aligned", BN_PLAN_CASES,
                         ids=[f"{r}x{f}-{i}{'' if a else '-unaligned'}"
                              for r, f, i, a in BN_PLAN_CASES])
def test_batch_norm_plan_covers_and_sums(r, f, itemsize, aligned):
    plan = batchnorm.launch_plan(r, f, itemsize, aligned)
    per_vector = 16 // itemsize
    assert plan.vec == (per_vector if aligned and f % per_vector == 0
                        else 1)
    assert plan.lanes <= batchnorm.MAX_LANES
    assert batchnorm.PASS_THREADS % plan.lanes == 0
    assert plan.tiles * plan.chunks <= batchnorm.TARGET_BLOCKS + plan.tiles
    assert plan.chunks <= 65535
    rng = np.random.default_rng(r + f)
    a = (rng.standard_normal((r, f)) * 2 + 0.5).astype(np.float32)
    got = _emulate_bn_sums(a, plan)
    a64 = a.astype(np.float64)
    for k, terms in enumerate((a64, a64 * a64)):
        # fp32 sums of at most a few hundred terms at each level
        np.testing.assert_allclose(got[k], terms.sum(0), rtol=0,
                                   atol=1e-6 * np.abs(terms).sum(0).max())


@pytest.mark.parametrize("r,f,itemsize,plan", [
    (64 * 300 * 33, 64, 2, (8, 8, 1, 1024, 619)),    # fall tcn BN, bf16
    (64 * 300, 33 * 256, 2, (8, 32, 33, 32, 600)),   # fall Shift_gcn bn
    (128 * 300 * 25, 64, 4, (4, 16, 1, 1024, 938)),  # NTU tcn BN, fp32
    (64 * 300, 150, 4, (1, 32, 5, 205, 94)),         # NTU data_bn
], ids=["fall_tcn", "fall_gcn", "ntu_tcn", "ntu_data_bn"])
def test_batch_norm_plan_at_the_models_shapes(r, f, itemsize, plan):
    # from (R, F) and the alignment alone, never the device: about
    # TARGET_BLOCKS blocks of 16-byte runs, one-element runs where F is
    # not a multiple of a vector
    assert batchnorm.launch_plan(r, f, itemsize, True) == plan


# ---------------------------------------------------------------------------
# K4/K5 on the tensor cores: the 3xTF32 arithmetic and the gate identity
# ---------------------------------------------------------------------------


def _tf32_rna(a: np.ndarray) -> np.ndarray:
    """Round fp32 to TF32 (10-bit mantissa), to nearest, ties away from
    zero: cvt.rna.tf32.f32, as the kernel does it on the integer pipe."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _mma_tf32(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a (M, K) @ b (K, N) as the kernel's mma.sync k8 steps: fp32
    accumulator, TF32 operands (products exact), 3 passes (a_small*b_big,
    a_big*b_small, then a_big*b_big) or 1 (a_big*b_big)."""
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    a_small, b_small = _tf32_rna(a - a_big), _tf32_rna(b - b_big)
    terms = ([(a_small, b_big), (a_big, b_small), (a_big, b_big)]
             if passes == 3 else [(a_big, b_big)])
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for p, q in terms:
            step = p[:, k0:k0 + 8].astype(np.float64) @ q[k0:k0 + 8].astype(
                np.float64)
            acc = (acc + step).astype(np.float32)
    return acc


@pytest.mark.parametrize("kernel", ["K4", "K5"])
def test_3xtf32_product_meets_fp32_tolerance(kernel):
    # Why K4/K5 do three TF32 products: at C = D = 256, with inputs drawn as
    # chip_smoke.py draws them, 3xTF32 stays within the card check's fp32
    # tolerance (2e-5 of scale) of an fp64 product; one TF32 product, which
    # keeps ~3 decimal digits, does not.
    rng = np.random.default_rng(30)
    r, v, c, d = 60, 33, 256, 256
    idx = (np.arange(v)[:, None] + np.arange(c)[None, :]) % v
    if kernel == "K4":
        x = rng.standard_normal((r, v, c)).astype(np.float32)
        gate = (np.tanh(rng.standard_normal((v, c))) + 1.0).astype(np.float32)
        a = (x[:, idx, np.arange(c)] * gate).reshape(r * v, c)  # h in fp32
        b = (rng.standard_normal((c, d)) * d ** -0.5).astype(np.float32)
    else:
        g = rng.standard_normal((r, v, d)).astype(np.float32)
        a = g[:, idx, np.arange(d)].reshape(r * v, d)  # shear_in(g)
        b = (rng.standard_normal((c, d)) * d ** -0.5).astype(np.float32).T
    want = a.astype(np.float64) @ b.astype(np.float64)
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    err3 = float(np.abs(_mma_tf32(a, b, 3) - want).max())
    err1 = float(np.abs(_mma_tf32(a, b, 1) - want).max())
    assert err3 <= tol / 20, (err3, tol)
    assert err1 > tol, (err1, tol)


@pytest.mark.parametrize("v", [25, 33])
@pytest.mark.parametrize("c", [3, 64, 130])
def test_gate_identity_of_the_shear(v, c):
    # shear_in(x) * gate == shear_in(x * shear_out(gate)): the move the JAX
    # dx path makes with spatial_shift(gate, -1) (shift_gcn_kernel.py
    # _run_dx), which lets K4 read the gate at the fragment row's own joint
    # and K5 multiply by it at the source joint of its store
    rng = np.random.default_rng(v * 1000 + c)
    x = rng.standard_normal((4, v, c)).astype(np.float32)
    gate = (np.tanh(rng.standard_normal((v, c))) + 1.0).astype(np.float32)
    lhs = np.asarray(sgk._shear_in(jnp.asarray(x), v) * jnp.asarray(gate))
    rhs = np.asarray(sgk._shear_in(
        jnp.asarray(x) * jax_spatial_shift(jnp.asarray(gate), -1), v))
    np.testing.assert_array_equal(lhs, rhs)
    xt, gt = torch.from_numpy(x), torch.from_numpy(gate)
    port = spatial_shift.spatial_shift(
        xt * spatial_shift.spatial_shift(gt, -1), +1)
    np.testing.assert_array_equal(port.numpy(), lhs)
    np.testing.assert_array_equal(
        (spatial_shift.spatial_shift(xt, +1) * gt).numpy(), lhs)


# ---------------------------------------------------------------------------
# K6: the weight gradients (dgate, dW, dbias) in one kernel
# ---------------------------------------------------------------------------


def _jax_weight_grads(x, gate, w, b, g):
    """(dgate, dw, dbias) of sum(fused_shift_gcn(x, gate, w, b) * g) from
    the JAX package's custom VJP (Pallas kernels)."""
    def loss(gate_, w_, b_):
        return jnp.sum(sgk.fused_shift_gcn(jnp.asarray(x), gate_, w_, b_,
                                           32) * g)

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (gate, w, b)))
    return [np.asarray(a) for a in grads]


def _shift_gcn_inputs(rng, r, v, c, d):
    x = rng.standard_normal((r, v, c)).astype(np.float32)
    gate = (np.tanh(rng.standard_normal((v, c))) + 1.0).astype(np.float32)
    w = (rng.standard_normal((c, d)) * d ** -0.5).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    g = rng.standard_normal((r, v, d)).astype(np.float32)
    return x, gate, w, b, g


@pytest.mark.parametrize("v", [25, 33, 40])
@pytest.mark.parametrize("c,d", [(3, 8), (8, 16), (16, 8)])
def test_wgrad_matches_pallas(interpret, v, c, d):
    # the launcher (its plain version on CPU tensors) against the JAX VJP,
    # which takes dgate through h / gate: 1e-5 of each gradient's scale
    rng = np.random.default_rng(11 * v + c + d)
    x, gate, w, b, g = _shift_gcn_inputs(rng, 40, v, c, d)
    want = _jax_weight_grads(x, gate, w, b, g)
    got = shift_gcn_kernel.shift_gcn_wgrad(
        *map(torch.from_numpy, (x, g, gate, w)))
    for name, a, ref, shape in zip(("dgate", "dw", "dbias"), got, want,
                                   ((v, c), (c, d), (d,))):
        assert a.shape == shape and a.dtype == torch.float32
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(a.numpy(), ref, atol=1e-5 * scale,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("v,d", [(25, 8), (33, 130), (144, 64), (543, 64)])
def test_dbias_needs_no_shear(v, d):
    # the shear permutes the joints within each frame, so the sum of the
    # sheared cotangent over (R, V) is the plain sum: K6 adds the values as
    # it loads them.  Small integers keep every sum exact.
    rng = np.random.default_rng(v + d)
    g = rng.integers(-8, 8, (6, v, d)).astype(np.float32)
    sheared = np.asarray(sgk._shear_in(jnp.asarray(g), v))
    np.testing.assert_array_equal(sheared.sum((0, 1)), g.sum((0, 1)))
    _, _, dbias = spatial_shift.shift_gcn_wgrad_reference(
        torch.from_numpy(g[:, :, :3]), torch.from_numpy(g),
        torch.ones(v, 3), torch.zeros(3, d))
    np.testing.assert_array_equal(dbias.numpy(), g.sum((0, 1)))


# joints a warp of K6 (csrc/shift_gcn.cu: kWgJoints)
WGRAD_JOINTS_A_WARP = 3

# (R, C, D) of one train step's launches, 64 clips (V=33)
TRAIN_WGRAD_SHAPES = [(19200, 3, 64), (19200, 64, 64), (19200, 64, 128),
                      (9600, 128, 128), (9600, 128, 256), (4800, 256, 256)]
# joint counts past K4's 144-row frame tile: K6 splits them into groups
WIDE_JOINTS = (145, 256, 543)


def _wave_fill(parts, r, v, c, d):
    """(blocks, share of the last wave's SMs those blocks keep busy)."""
    tiles = (-(-v // shift_gcn_kernel.WGRAD_GROUP)
             * -(-c // 32) * -(-d // 32))
    blocks = parts * tiles
    waves = -(-blocks // shift_gcn_kernel.WGRAD_BLOCKS)
    return blocks, blocks / (waves * shift_gcn_kernel.WGRAD_BLOCKS)


@pytest.mark.parametrize("v", (33,) + WIDE_JOINTS)
@pytest.mark.parametrize("r,c,d", TRAIN_WGRAD_SHAPES)
def test_wgrad_split_covers_r(r, c, d, v):
    # every frame in exactly one chunk, chunks whole bf16 stages; one
    # joint group: one wave of at most 132 blocks; joint groups: waves of
    # 132 blocks, the last at least 90% full
    parts, chunk = shift_gcn_kernel.wgrad_split(r, v, c, d)
    assert chunk % 16 == 0
    assert (parts - 1) * chunk < r <= parts * chunk
    blocks, fill = _wave_fill(parts, r, v, c, d)
    if v <= shift_gcn_kernel.WGRAD_GROUP:
        assert 64 < blocks <= shift_gcn_kernel.WGRAD_BLOCKS
    else:
        assert fill >= shift_gcn_kernel.WGRAD_WAVE_FILL


# (T, C, D) of the default backbone's launches
BACKBONE_WGRAD_SHAPES = [(300, 3, 64), (300, 64, 64), (300, 64, 128),
                         (150, 128, 128), (150, 128, 256), (75, 256, 256)]
# (parts, chunk) of those launches at V <= 33 before the joint groups'
# split, by clips a launch: the split of the one-group path, pinned
ONE_GROUP_SPLITS = {
    8: [(50, 48), (30, 80), (15, 160), (8, 160), (4, 304), (2, 304)],
    64: [(64, 304), (33, 592), (16, 1200), (8, 1200), (4, 2400),
         (2, 2400)]}


@pytest.mark.parametrize("clips", [8, 64])
@pytest.mark.parametrize("v", [25, 33])
def test_wgrad_split_pinned_at_one_group(v, clips):
    # V <= 33 keeps its split, so its summation order, bit for bit
    assert [shift_gcn_kernel.wgrad_split(clips * t, v, c, d)
            for t, c, d in BACKBONE_WGRAD_SHAPES] == ONE_GROUP_SPLITS[clips]


@pytest.mark.parametrize("clips", [8, 64])
@pytest.mark.parametrize("v", WIDE_JOINTS)
def test_wgrad_split_fills_waves(v, clips):
    # past one joint group every backbone launch fills whole waves of 132
    # blocks or leaves under 10% of the last one idle, in chunks of whole
    # bf16 stages; no split with the same fill runs fewer waves x frames
    for t, c, d in BACKBONE_WGRAD_SHAPES:
        r = clips * t
        parts, chunk = shift_gcn_kernel.wgrad_split(r, v, c, d)
        blocks, fill = _wave_fill(parts, r, v, c, d)
        assert chunk % 16 == 0 and (parts - 1) * chunk < r <= parts * chunk
        assert fill >= 0.9, (t, c, d, parts, chunk, blocks)
        cost = -(-blocks // 132) * (chunk + 32)
        for other in range(16, r + 16, 16):
            p = -(-r // other)
            b, f = _wave_fill(p, r, v, c, d)
            assert f < 0.9 or -(-b // 132) * (other + 32) >= cost


@pytest.mark.parametrize("itemsize", [4, 2])
def test_wgrad_strips_fit_and_spread_banks(itemsize):
    # the joint groups' layout (csrc wg_layout) fits one block's 227 KiB
    # with its two stages at every V past one group, as the launcher
    # requires; each fragment load of a warp (lanes along 8 channels and
    # 4 frames) meets no bank conflict in fp32 and at most a 2-way one in
    # bf16
    for v in range(34, 2048):
        lay = shift_gcn_kernel.wgrad_layout(v, itemsize)
        assert lay["smem"] <= shift_gcn_kernel.WGRAD_SMEM_MAX, v
        assert lay["joints"] + lay["width"] - 1 <= lay["rows"] <= v
        assert lay["rows"] % 2 == 1 and lay["ss"] * itemsize % 128 == 0
    for v in (34, 145, 543):
        lay = shift_gcn_kernel.wgrad_layout(v, itemsize)
        kw, fs, ss = lay["width"], lay["fs"], lay["ss"]
        gq, tq = np.arange(32) // 4, np.arange(32) % 4
        # fp32: frames tq (and tq + 4); bf16: frames 2 tq (and 2 tq + 1)
        frame = tq if itemsize == 4 else 2 * tq
        for uu in range(lay["joints"]):
            for cb in range(0, 32, 8):
                at = (frame * fs + (cb // kw) * ss + (cb % kw) * (kw + 1)
                      + uu * kw + gq * (kw + 1))
                words = at * itemsize // 4
                conflicts = max(len(set(words[(words % 32) == bank]))
                                for bank in range(32))
                assert conflicts <= (1 if itemsize == 4 else 2), (v, uu, cb)


def _stage_strips(src, f0, f_end, base, ch0, lay, writes):
    """One slab of csrc wg_stage_strips (and of its tensor copies, which
    land the same elements): kF frames of a joint group's strips of src
    (R, V, n), flat [strip * ss + frame * fs + row * kW + e]; ``writes``
    counts the positions written."""
    r, v, n = src.shape
    kw, rows, fs, kf = lay["width"], lay["rows"], lay["fs"], lay["frames"]
    ss = lay["ss"]
    out = np.zeros(32 // kw * ss, src.dtype)
    for f in range(kf):
        for k in range(32 // kw):
            ch_k = ch0 + k * kw
            if ch_k >= n:
                continue
            rb = base + k * kw
            rb -= v if rb >= v else 0
            row = rb + np.arange(rows)
            row -= np.where(row >= v, v, 0)
            assert (row < v).all()
            e = np.arange(min(kw, n - ch_k))
            at = k * ss + f * fs + np.arange(rows)[:, None] * kw + e
            assert at.max() < k * ss + (f + 1) * fs <= (k + 1) * ss
            writes[at] += 1
            if f0 + f < f_end:
                out[at] = src[f0 + f, row[:, None], ch_k + e]
    return out


def _wgrad_strips_emulated(x, g, gate, w, d0, itemsize):
    """K6 past one joint group in numpy: the split, the blocks (chunk,
    joint group, c tile, d tile), each stage's strips staged as the
    kernel stages them and read at its fragment offsets, a stage's
    products summed and added to fp32 sums, the epilogue's partials and
    the final sums in the kernel's order.  Returns (dgate, dw, dbias) and
    how often each (frame, joint, c, d) product was summed."""
    r, v, c = x.shape
    d = w.shape[1]
    lay = shift_gcn_kernel.wgrad_layout(v, itemsize)
    groups, joints, kw = lay["groups"], lay["joints"], lay["width"]
    fs, kf, ss = lay["fs"], lay["frames"], lay["ss"]
    parts, chunk = shift_gcn_kernel.wgrad_split(r, v, c, d)
    c_tiles, d_tiles = -(-c // 32), -(-d // 32)
    count = np.zeros((r, v, c, d), np.uint8)
    dw_part = np.zeros((parts, groups, c, d), np.float32)
    dgate_part = np.zeros((parts, d_tiles, v, c), np.float32)
    bias_part = np.zeros((parts, groups, d), np.float32)
    # fragment channel cb + gq of joint uu: strip_at(cb, uu)
    cc = np.arange(32)
    cb, gq = cc - cc % 8, cc % 8
    for p in range(parts):
        f_begin, f_end = p * chunk, min(r, (p + 1) * chunk)
        for jg in range(groups):
            u0 = jg * joints
            nj = min(joints, v - u0)
            uu = np.arange(nj)[:, None]
            at = (cb // kw) * ss + (cb % kw) * (kw + 1) + uu * kw + gq * (
                kw + 1)
            for cti in range(c_tiles):
                for dti in range(d_tiles):
                    c0, e0 = 32 * cti, 32 * dti
                    nc, nd = min(32, c - c0), min(32, d - e0)
                    base_x = (u0 + c0) % v
                    base_g = (u0 + d0 % v + e0) % v
                    acc = np.zeros((nj, 32, 32), np.float32)
                    bacc = np.zeros(32, np.float32)
                    for f0 in range(f_begin, f_end, kf):
                        writes = np.zeros((2, 32 // kw * ss), np.int32)
                        xs = _stage_strips(x, f0, f_end, base_x, c0, lay,
                                           writes[0])
                        gs = _stage_strips(g, f0, f_end, base_g, e0, lay,
                                           writes[1])
                        assert writes.max() <= 1
                        frames = np.arange(kf)[:, None, None] * fs
                        a = xs[frames + at]  # (kf, nj, 32)
                        b = gs[frames + at]
                        live = min(kf, f_end - f0)
                        rr = np.arange(f0, f0 + live)[:, None, None]
                        us = (u0 + uu)[None]
                        np.testing.assert_array_equal(
                            a[:live, :, :nc],
                            x[rr, (us + c0 + cc[:nc]) % v, c0 + cc[:nc]])
                        np.testing.assert_array_equal(
                            b[:live, :, :nd], g[rr, (us + d0 + e0
                                                     + cc[:nd]) % v,
                                                e0 + cc[:nd]])
                        count[f0:f0 + live, u0:u0 + nj, c0:c0 + nc,
                              e0:e0 + nd] += 1
                        stage = np.einsum("fuc,fud->ucd", a.astype(
                            np.float64), b.astype(np.float64))
                        acc = (acc + stage.astype(np.float32)).astype(
                            np.float32)
                        if cti == 0:
                            bacc = (bacc + b.sum((0, 1), dtype=np.float32)
                                    ).astype(np.float32)
                    m = acc[:, :nc, :nd]
                    dgate_part[p, dti, u0:u0 + nj, c0:c0 + nc] = (
                        m * w[c0:c0 + nc, e0:e0 + nd]).sum(
                            -1, dtype=np.float32)
                    warps = -(-nj // WGRAD_JOINTS_A_WARP)
                    per_warp = [sum(gate[u0 + u, c0:c0 + nc, None] * m[u]
                                    for u in range(wp, nj, warps))
                                for wp in range(warps)]
                    dw_p = per_warp[0]
                    for part in per_warp[1:]:
                        dw_p = (dw_p + part).astype(np.float32)
                    dw_part[p, jg, c0:c0 + nc, e0:e0 + nd] = dw_p
                    if cti == 0:
                        bias_part[p, jg, e0:e0 + nd] = bacc[:nd]
    final = [np.zeros((v, c), np.float32), np.zeros((c, d), np.float32),
             np.zeros(d, np.float32)]
    for k in range(parts * d_tiles):
        final[0] = (final[0] + dgate_part.reshape(-1, v, c)[k]).astype(
            np.float32)
    for k in range(parts * groups):
        final[1] = (final[1] + dw_part.reshape(-1, c, d)[k]).astype(
            np.float32)
        final[2] = (final[2] + bias_part.reshape(-1, d)[k]).astype(
            np.float32)
    return final, count


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d0_tiles", [0, 1])
@pytest.mark.parametrize("v", [34, 70, 145, 543])
def test_wgrad_strips_emulation_matches_plain(v, d0_tiles, itemsize):
    # K6 past one joint group (csrc wgrad_partial_kernel<T, true>): each
    # (frame, joint, c, d) product summed exactly once across blocks,
    # stages and the split, every staged strip element the shear's, and
    # the sums within fp32 tolerance of the plain version, at d0 = 0 and
    # d0 = D (a rank's slice of a layer twice as wide); C = 40 and D = 20
    # leave ragged tiles, R = 24 a ragged chunk or stage
    rng = np.random.default_rng(v + 7 * d0_tiles + itemsize)
    r, c, d = 24, 40, 20
    x, gate, w, _, g = _shift_gcn_inputs(rng, r, v, c, d)
    if itemsize == 2:  # the values a bf16 input holds
        x, g = (torch.from_numpy(a).bfloat16().float().numpy()
                for a in (x, g))
    d0 = d0_tiles * d
    got, count = _wgrad_strips_emulated(x, g, gate, w, d0, itemsize)
    np.testing.assert_array_equal(count, 1)
    want = shift_gcn_kernel.shift_gcn_wgrad(
        *map(torch.from_numpy, (x, g, gate, w)), d0)
    for name, a, ref in zip(("dgate", "dw", "dbias"), got, want):
        scale = max(1.0, float(ref.abs().max()))
        np.testing.assert_allclose(a, ref.numpy(), rtol=0,
                                   atol=FP32_TOL * scale, err_msg=name)


@pytest.mark.parametrize("v", WIDE_JOINTS)
def test_wgrad_groups_stage_the_shear(v):
    # each joint in one group of at most 33; a strip k of 32 // itemsize
    # channels, staged from row (u0 + c0 + k kW) % V as it wraps, holds at
    # strip_at(cb, uu) (csrc wgrad_partial_kernel) the shear's element
    # x[(u0 + uu + c0 + cb + gq) % V, c0 + cb + gq]
    rng = np.random.default_rng(v)
    x = rng.standard_normal((3, v, 64)).astype(np.float32)
    for itemsize in (4, 2):
        lay = shift_gcn_kernel.wgrad_layout(v, itemsize)
        groups, joints, kw = lay["groups"], lay["joints"], lay["width"]
        ss = lay["ss"]
        assert (groups - 1) * joints < v <= groups * joints
        assert joints <= shift_gcn_kernel.WGRAD_GROUP
        cc = np.arange(32)
        cb, gq = cc - cc % 8, cc % 8
        for jg in range(groups):
            u0 = jg * joints
            uu = np.arange(min(joints, v - u0))[:, None]
            at = (cb // kw) * ss + (cb % kw) * (kw + 1) + uu * kw + gq * (
                kw + 1)
            for c0 in (0, 32):
                staged = _stage_strips(x, 0, 3, (u0 + c0) % v, c0, lay,
                                       np.zeros(32 // kw * ss, np.int32))
                np.testing.assert_array_equal(
                    staged[at], x[0, (u0 + uu + c0 + cc) % v, c0 + cc])


def _rz32(v: np.ndarray) -> np.ndarray:
    """fp64 -> fp32 rounded toward zero: how the tensor cores' fp32
    accumulator drops the low bits of a sum."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tensor_core_sum(a: np.ndarray, b: np.ndarray, flush: bool):
    """Batched a (J, C, K) @ b (J, K, D) as K6's 3xTF32 mma.sync k8 steps
    with the accumulator truncating (``_rz32``).  flush=True is the
    kernel's scheme: each k8 step (an fp32 stage) summed from zero, then
    added to an fp32 sum rounded to nearest; flush=False keeps the whole
    chunk in the tensor cores' accumulator."""
    a_big, b_big = _tf32_rna(a), _tf32_rna(b)
    a_small, b_small = _tf32_rna(a - a_big), _tf32_rna(b - b_big)
    m = np.zeros((a.shape[0], a.shape[1], b.shape[2]), np.float32)
    for k0 in range(0, a.shape[2], 8):
        sa = np.zeros_like(m) if flush else m
        for pa, pb in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
            sa = _rz32(sa + pa[:, :, k0:k0 + 8].astype(np.float64)
                       @ pb[:, k0:k0 + 8].astype(np.float64))
        m = (m + sa).astype(np.float32) if flush else sa
    return m


def _wgrad_emulated(x, g, gate, w, parts, chunk):
    """K6's arithmetic in numpy for V <= 33 and C, D <= 32 (one joint
    group, one tile): per chunk, M by ``_tensor_core_sum``; the block's
    dgate (sum over d of M * W) and dW (per warp the sum over its joints
    of gate * M, then over the warps in order); then the chunks summed in
    order."""
    r, v, c = x.shape
    d = w.shape[1]
    warps = -(-v // WGRAD_JOINTS_A_WARP)
    sx = x[:, (np.arange(v)[:, None] + np.arange(c)) % v, np.arange(c)]
    gz = g[:, (np.arange(v)[:, None] + np.arange(d)) % v, np.arange(d)]
    dgate = np.zeros((v, c), np.float32)
    dw = np.zeros((c, d), np.float32)
    dbias = np.zeros(d, np.float32)
    for p in range(parts):
        a = sx[p * chunk:(p + 1) * chunk].transpose(1, 2, 0)  # (V, C, k)
        bm = gz[p * chunk:(p + 1) * chunk].transpose(1, 0, 2)  # (V, k, D)
        pad = -a.shape[2] % 8
        m = _tensor_core_sum(np.pad(a, ((0, 0), (0, 0), (0, pad))),
                             np.pad(bm, ((0, 0), (0, pad), (0, 0))), True)
        dgate += (m * w[None]).sum(-1, dtype=np.float32)
        per_warp = [sum(gate[u][:, None] * m[u]
                        for u in range(wp, v, warps)) for wp in range(warps)]
        dw_p = per_warp[0]
        for part in per_warp[1:]:
            dw_p = (dw_p + part).astype(np.float32)
        dw = (dw + dw_p).astype(np.float32)
        dbias = (dbias + bm.sum((0, 1), dtype=np.float32)).astype(
            np.float32)
    return dgate, dw, dbias


@pytest.mark.parametrize("c,d", [(3, 16), (16, 8)])
@pytest.mark.parametrize("split", ["chosen", "deepest"])
def test_wgrad_emulation_meets_fp32_tolerance(interpret, c, d, split):
    # K6 at train depth (R = 4800 frames, V = 33): its 3xTF32 k8 steps on
    # truncating accumulators flushed every stage, the split of R into
    # partials and the fixed order of the final sums stay within 1e-5 of
    # scale of the JAX gradients, and within 1e-6 of an fp64 sum.
    # "chosen" is the split the wrapper picks for these shapes; "deepest"
    # that of the 256-wide train layers (2 chunks of 2400 frames).
    rng = np.random.default_rng(40 + c + d)
    r, v = 4800, 33
    x, gate, w, b, g = _shift_gcn_inputs(rng, r, v, c, d)
    parts, chunk = (shift_gcn_kernel.wgrad_split(r, v, c, d)
                    if split == "chosen" else (2, 2400))
    got = _wgrad_emulated(x, g, gate, w, parts, chunk)
    want = _jax_weight_grads(x, gate, w, b, g)
    exact = spatial_shift.shift_gcn_wgrad_reference(
        *(torch.from_numpy(a).double() for a in (x, g, gate, w)))
    for name, a, ref, ref64 in zip(("dgate", "dw", "dbias"), got, want,
                                   exact):
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(a, ref, atol=1e-5 * scale, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(a, ref64.numpy(), atol=1e-6 * scale,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("kind", ["normal", "relu"])
def test_tensor_core_sum_needs_a_flush(kind):
    # Why K6 flushes the tensor cores' sum every stage: over a 2400-frame
    # chunk (300 k8 steps, 900 truncating accumulations) one accumulator
    # drifts past the card check's 2e-5 of scale of an fp64 sum (a first
    # build of K6 that summed a chunk so came close to it on the card);
    # flushed, it stays under 1e-6.  "relu": nonnegative x and a cotangent
    # with a mean.
    rng = np.random.default_rng(50)
    a = rng.standard_normal((33, 8, 2400)).astype(np.float32)
    b = rng.standard_normal((33, 2400, 16)).astype(np.float32)
    if kind == "relu":
        a, b = np.abs(a), b + np.float32(0.3)
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = float(np.abs(want).max())
    flushed = float(np.abs(_tensor_core_sum(a, b, True) - want).max())
    whole = float(np.abs(_tensor_core_sum(a, b, False) - want).max())
    assert flushed < 1e-6 * scale < 2e-5 * scale < whole, (flushed, whole)


# K4 / K5 wide tiles (csrc/shift_gcn.cu, kWide: V > 144): a tile is 144
# joints of one frame, a k-slice 32 channels
TILE_ROWS, TILE_K = 144, 32


def _wide_tile_emulated(x, gate, w, bias, d0, dx, cols, vec):
    """K4 (dx=False: x (R, V, C), w (C, D), output channels from d0) or
    K5 (dx=True: x the cotangent (R, V, D), w (C, D), dx (R, V, C)) through
    the wide tiles' index arithmetic in float64: per (frame, tile of 144
    joints, column tile of ``cols``) each k-slice stages the 175-row
    window from joint (u0 + k0') % V as it wraps, row m and channel kk
    read slot m + kk, K4 gates at the tile's joint u0 + m; the epilogue
    walks each ``vec``-column chunk's q over min(V, rows + vec - 1) and
    writes the element e whose source row q - e (mod V) lies in the tile.
    Returns the output and the count of writes of each element."""
    r, v, kdim = x.shape
    wt = w.T if dx else w  # (kdim, n)
    n = wt.shape[1]
    out = np.zeros((r, v, n))
    writes = np.zeros((r, v, n), np.int64)
    rows_k = np.arange(TILE_ROWS)[:, None]
    kk = np.arange(TILE_K)[None]
    for f in range(r):
        for u0 in range(0, v, TILE_ROWS):
            rows = min(TILE_ROWS, v - u0)
            for n0 in range(0, n, cols):
                z = np.zeros((TILE_ROWS, cols))
                for k0 in range(0, kdim, TILE_K):
                    first = (u0 + (d0 % v if dx else 0) + k0) % v
                    joints = (first + np.arange(TILE_ROWS + TILE_K - 1)) % v
                    ch = k0 + np.arange(TILE_K)
                    live = ch < kdim
                    slab = np.where(live, x[f][joints][:, np.minimum(
                        ch, kdim - 1)], 0.0)
                    a = slab[rows_k + kk, kk]
                    if not dx:
                        joint = np.minimum(u0 + rows_k, v - 1)
                        a = a * np.where(live & (u0 + rows_k < v), gate[
                            joint, np.minimum(ch, kdim - 1)], 0.0)
                    b = np.zeros((TILE_K, cols))
                    nk = min(kdim - k0, TILE_K)
                    nc = min(n - n0, cols)
                    b[:nk, :nc] = wt[k0:k0 + nk, n0:n0 + nc]
                    z += a @ b
                if not dx:
                    z[:, :min(n - n0, cols)] += bias[n0:n0 + cols]
                for col in range(n0, min(n0 + cols, n), vec):
                    j = col - n0
                    w0 = (u0 + ((0 if dx else d0) + col) % v) % v
                    q = np.arange(min(v, rows + vec - 1))
                    for e in range(vec):
                        m = q - e
                        m = np.where(m < 0, m + v, m)
                        keep = m < rows
                        m = m[keep]
                        val = z[m, j + e]
                        if dx:
                            val = val * gate[u0 + m, col + e]
                        row = (w0 + q[keep]) % v
                        out[f, row, col + e] = val
                        writes[f, row, col + e] += 1
    return out, writes


# (V, C, D, d0, kernel, column tile, vector): K4 and K5 at the backbone's
# widths past 144 joints, 128- and 64-column tiles, 16-byte stores of 4
# (fp32) and 8 (bf16) elements, and the element stores of unit 1's C=3
# and of an odd width
WIDE_TILE_CASES = [
    (145, 64, 128, 0, "K4", 128, 4), (256, 3, 64, 32, "K4", 64, 1),
    (543, 130, 64, 40, "K4", 64, 8), (543, 64, 64, 0, "K4", 64, 4),
    (145, 64, 128, 64, "K5", 64, 4), (256, 130, 64, 0, "K5", 128, 1),
    (543, 3, 64, 0, "K5", 64, 1), (543, 128, 256, 256, "K5", 128, 8),
]


@pytest.mark.parametrize("v,c,d,d0,kernel,cols,vec", WIDE_TILE_CASES)
def test_wide_tile_emulation_matches_plain(v, c, d, d0, kernel, cols, vec):
    # the wide tiles' staging, fragment rows and epilogue give the plain
    # versions' outputs, each output element written exactly once across
    # the tiles of its frame
    # against the definitions in float64 (csrc/shift_gcn.cu's header) at
    # float64 roundoff, and against the plain versions at fp32 roundoff
    rng = np.random.default_rng(v + c + d)
    inputs = _shift_gcn_inputs(rng, 2, v, c, d)
    x, gate, w, b, g = (a.astype(np.float64) for a in inputs)
    u = np.arange(v)[:, None]
    if kernel == "K4":
        got, writes = _wide_tile_emulated(x, gate, w, b, d0, False, cols,
                                          vec)
        cc = np.arange(c)[None]
        z = (x[:, (u + cc) % v, cc] * gate) @ w + b
        dd = np.arange(d)[None]
        want = z[:, (u - d0 - dd) % v, dd]
        plain = spatial_shift.shift_gcn_transform(
            *(torch.from_numpy(a) for a in inputs[:4]), d0)
    else:
        got, writes = _wide_tile_emulated(g, gate, w, None, d0, True, cols,
                                          vec)
        dd = np.arange(d)[None]
        dz = g[:, (u + d0 + dd) % v, dd] @ w.T
        cc = np.arange(c)[None]
        want = dz[:, (u - cc) % v, cc] * gate[(u - cc) % v, cc]
        plain = spatial_shift.shift_gcn_dx_reference(
            *(torch.from_numpy(a) for a in (inputs[4], inputs[1],
                                            inputs[2])), d0)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, plain.numpy(), rtol=0,
                               atol=FP32_TOL * np.abs(want).max())


def _mma_shared_bytes(itemsize, dx, cols, wide, v=33):
    """Dynamic shared memory of one K4 / K5 block (csrc/shift_gcn.cu:
    Layout::bytes): the fragments or the z tile, whichever is larger,
    then 2 stages of slab, W tile and K4's gate slice."""
    lda = 36 if itemsize == 4 else 40
    frag = 2 * (TILE_ROWS // 16 * 4 * 32 * 16) + cols // 8 * 4 * 32 * 16
    region = max(frag, TILE_ROWS * (cols + 4) * 4)
    slab = (TILE_ROWS + TILE_K - 1 if wide else TILE_ROWS) * lda * itemsize
    w_tile = (cols * 36 if dx else TILE_K * (cols + 8)) * 4
    gate = 0 if dx else (TILE_ROWS if wide else v) * 36 * 4
    return region + 2 * (slab + w_tile + gate)


@pytest.mark.parametrize("dx", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("cols", [64, 128])
def test_wide_tile_shared_memory_fits_at_any_v(dx, itemsize, cols):
    # a wide tile stages 175 slab rows and 144 gate rows whatever V, so it
    # fits one block's 227 KiB at every V past 144; K4's fp32 128-column
    # tile is the largest, 202,720 B (161,824 B at V=33 with whole frames)
    wide = _mma_shared_bytes(itemsize, dx, cols, True)
    assert wide <= 232448
    if (itemsize, dx, cols) == (4, False, 128):
        assert (wide, _mma_shared_bytes(4, False, 128, False)) == (
            202720, 161824)
