"""The spatial kernels K4, K5 and K6 at a tensor-parallel rank's
output-channel offset d0, through their launchers (the plain versions on
CPU tensors), on the CPU:

- K4's output, and K6's dW and dbias, at each slice [d0, d0 + D / M)
  equal the matching columns of the whole layer's (d0 = 0), and the
  whole layer's forward and weight gradients are the reference package's
  Pallas kernel's (interpret mode) within its fp32 tolerance;
- K5's dx and K6's dgate, this slice's parts, summed over the slices
  equal the whole layer's within fp32 roundoff;
- fp32 and bf16 inputs, D / M of 1, 8 and 32, V = 33 and 25;
- the autograd Function and the registered op carry d0, and a negative
  d0 is refused."""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shift_gcn_torch.ops import shift_gcn_kernel as sk

sgk = importlib.import_module("shift_gcn_tpu.ops.pallas.shift_gcn_kernel")

# (local width D / M, model ranks M): D = 3, 32 and 64
SLICES = [(1, 3), (8, 4), (32, 2)]
C_IN = 8


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(sgk, "_INTERPRET", True)


def _inputs(v, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((12, v, C_IN)).astype(np.float32)
    gate = (np.tanh(rng.standard_normal((v, C_IN))) + 1.0).astype(np.float32)
    w = (rng.standard_normal((C_IN, d)) * d ** -0.5).astype(np.float32)
    b = rng.standard_normal(d).astype(np.float32)
    g = rng.standard_normal((12, v, d)).astype(np.float32)
    return x, gate, w, b, g


def _close(got, want, tol, label):
    scale = max(1.0, float(want.abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"{label}: {err:.3g} > {tol:g} of {scale:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("v", [25, 33])
@pytest.mark.parametrize("width,m", SLICES, ids=["D1", "D8", "D32"])
def test_offset_slices_match_whole_layer(interpret, dtype, v, width, m):
    d = width * m
    x, gate, w, b, g = map(torch.from_numpy, _inputs(v, d, 7 * v + d))
    x, g = x.to(dtype), g.to(dtype)
    out = sk.shift_gcn_forward(x, gate, w, b)
    dx = sk.shift_gcn_dx(g, gate, w)
    dgate, dw, dbias = sk.shift_gcn_wgrad(x, g, gate, w)
    if dtype == torch.float32:
        # the whole layer is the reference's Pallas kernel's
        want = sgk.fused_shift_gcn(*map(jnp.asarray, (
            x.numpy(), gate.numpy(), w.numpy(), b.numpy())), 32)
        _close(out, torch.from_numpy(np.array(want)), 1e-5, "K4 vs JAX")

        def loss(gate_, w_, b_):
            return jnp.sum(sgk.fused_shift_gcn(
                jnp.asarray(x.numpy()), gate_, w_, b_, 32) * g.numpy())

        for name, got, ref in zip(
                ("dgate", "dW", "dbias"), (dgate, dw, dbias),
                jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
                    *map(jnp.asarray, (gate.numpy(), w.numpy(),
                                       b.numpy())))):
            _close(got, torch.from_numpy(np.array(ref)), 1e-5,
                   f"{name} vs JAX")
    # an output element rounds once to its type either way; fp32 sums of
    # C_IN or R * V products in another blocking stay at fp32 roundoff
    one = 1e-6 if dtype == torch.float32 else 2 ** -8
    sums = [torch.zeros_like(dx, dtype=torch.float32),
            torch.zeros_like(dgate)]
    for rank in range(m):
        cols = slice(rank * width, (rank + 1) * width)
        d0 = cols.start
        ws, gs = w[:, cols].contiguous(), g[..., cols].contiguous()
        label = f"rank {rank} d0={d0}"
        _close(sk.shift_gcn_forward(x, gate, ws, b[cols], d0), out[..., cols],
               one, f"K4 {label}")
        part_dx = sk.shift_gcn_dx(gs, gate, ws, d0)
        assert part_dx.dtype == dtype
        part_dgate, part_dw, part_dbias = sk.shift_gcn_wgrad(x, gs, gate,
                                                             ws, d0)
        _close(part_dw, dw[:, cols], 1e-6, f"K6 dW {label}")
        _close(part_dbias, dbias[cols], 1e-6, f"K6 dbias {label}")
        sums[0] += part_dx.float()
        sums[1] += part_dgate
    # bf16: each part and the whole round once to bf16
    _close(sums[0], dx, 1e-6 if dtype == torch.float32 else m * 2 ** -8,
           "K5 dx summed over the slices")
    _close(sums[1], dgate, 1e-5, "K6 dgate summed over the slices")


def test_offset_reaches_the_function_and_the_op():
    x, gate, w, b, g = map(torch.from_numpy, _inputs(33, 16, 3))
    cols = slice(8, 16)
    ws = w[:, cols].contiguous().requires_grad_(True)
    bs = b[cols].clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    out = sk.fused_shift_gcn(xg, gate, ws, bs, 8)
    torch.testing.assert_close(
        out, torch.ops.shift_gcn_torch.shift_gcn(x, gate, ws.detach(),
                                                 bs.detach(), 8))
    torch.testing.assert_close(out.detach(),
                               sk.shift_gcn_forward(x, gate, w, b)[..., cols])
    out.backward(g[..., cols])
    torch.testing.assert_close(xg.grad, sk.shift_gcn_dx(
        g[..., cols].contiguous(), gate, ws.detach(), 8))
    torch.testing.assert_close(ws.grad, sk.shift_gcn_wgrad(
        x, g, gate, w)[1][:, cols])
    # the op's schema keeps d0 optional: a graph made without it is valid
    schema = torch.ops.shift_gcn_torch.shift_gcn.default._schema
    assert [a.name for a in schema.arguments] == ["x", "gate", "w", "bias",
                                                  "d0"]
    assert schema.arguments[-1].default_value == 0
    for launch in (lambda: sk.shift_gcn_forward(x, gate, w, b, -1),
                   lambda: sk.shift_gcn_dx(g, gate, w, -1),
                   lambda: sk.shift_gcn_wgrad(x, g, gate, w, -1)):
        with pytest.raises(ValueError, match="d0=-1"):
            launch()
