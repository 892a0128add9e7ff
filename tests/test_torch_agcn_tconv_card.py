"""2s-AGCN's 9-tap temporal conv kernels (``csrc/agcn_tconv.cu``) against
their plain versions in float64, on the card; each test skips on a
machine without a CUDA card.  Run on the card with
``python -m pytest --noconftest tests/test_torch_agcn_tconv_card.py``
(the suite's conftest sets up JAX, which this file does not use)."""

import pytest
import torch
import torch.nn.functional as F

from shift_gcn_torch import kernels
from shift_gcn_torch.models import agcn
from shift_gcn_torch.ops import agcn_tconv

# (T, C, stride) of the published units' convs: units 1-4, 5, 6-7, 8,
# 9-10; rows cut from N'V = 3200 to 256
UNITS = [(300, 64, 1), (300, 128, 2), (150, 128, 1), (150, 256, 2),
         (75, 256, 1)]
ROWS = 256
# the kernels' 3xTF32 products summed in another order than cuDNN's fp32:
# within twice cuDNN's own gap to float64, or this share of the largest
# value where cuDNN's gap is smaller
FLOOR = 2e-5


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def _inputs(t, cin, cout, stride, dev, rows=ROWS, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed + t + cin + stride)
    x = torch.randn(rows, t, cin, generator=gen, device=dev)
    w = torch.randn(cout, cin, 9, 1, generator=gen, device=dev) * \
        (2.0 / (cout * 9)) ** 0.5
    b = torch.randn(cout, generator=gen, device=dev) * 0.1
    dy = torch.randn(rows, agcn_tconv.out_frames(t, stride), cout,
                     generator=gen, device=dev)
    return x, w, b, dy


def _cudnn(x, w, b, dy, stride):
    """cuDNN's fp32 (TF32 off) forward, dx, dW and db on the (R, C, T, 1)
    layout."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        xx, ww, bb = (a.detach().clone().requires_grad_()
                      for a in (x, w, b))
        y = F.conv2d(xx.transpose(1, 2).unsqueeze(-1), ww, bb,
                     stride=(stride, 1), padding=(4, 0))
        y = y.squeeze(-1).transpose(1, 2)
        y.backward(dy)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    return y.detach(), xx.grad, ww.grad, bb.grad


def _gap(got, want):
    return float((got.double() - want).abs().max())


@pytest.mark.parametrize("unit", UNITS, ids=str)
def test_kernels_match_plain_in_float64(unit):
    """Forward, input gradient, weight and bias gradients within the
    larger of twice cuDNN-fp32's gap and FLOOR of the largest value;
    every output bit-equal across two launches; no launch error."""
    dev = _card()
    t, c, stride = unit
    x, w, b, dy = _inputs(t, c, c, stride, dev)
    kernels.reset_launches()
    outs = []
    for _ in range(2):
        y = agcn_tconv.tconv_forward(x, w, b, stride)
        dx = agcn_tconv.tconv_input_grad(dy, w, t, stride)
        dw, db = agcn_tconv.tconv_weight_grad(x, dy, stride)
        outs.append((y, dx, dw, db))
    torch.cuda.synchronize()
    for name, one, two in zip(("y", "dx", "dW", "db"), *outs):
        assert torch.equal(one, two), f"{name} differs between launches"
    assert kernels.LAUNCHES["agcn_tconv"] == 2
    assert kernels.LAUNCHES["agcn_tconv_input_grad"] == 2
    assert kernels.LAUNCHES["agcn_tconv_weight_grad"] == 2
    x64, w64, b64, dy64 = (a.double() for a in (x, w, b, dy))
    want = (agcn_tconv.tconv_forward_reference(x64, w64, b64, stride),
            agcn_tconv.tconv_input_grad_reference(dy64, w64, t, stride),
            *agcn_tconv.tconv_weight_grad_reference(x64, dy64, stride))
    library = _cudnn(x, w, b, dy, stride)
    for name, got, lib, ref in zip(("y", "dx", "dW", "db"), outs[0],
                                   library, want):
        tol = max(2 * _gap(lib, ref), FLOOR * float(ref.abs().max()))
        assert _gap(got, ref) <= tol, (name, _gap(got, ref), tol)


@pytest.mark.parametrize("shape", [(5, 33, 16, 32, 1), (3, 10, 12, 8, 2),
                                   (70, 4, 20, 132, 2)], ids=str)
def test_odd_shapes_match_plain(shape):
    """Rows, frames and channels that no tile divides: a few frames a
    row, channels past a chunk or a tile, more positions than a block."""
    dev = _card()
    rows, t, cin, cout, stride = shape
    x, w, b, dy = _inputs(t, cin, cout, stride, dev, rows=rows)
    got = (agcn_tconv.tconv_forward(x, w, b, stride),
           agcn_tconv.tconv_input_grad(dy, w, t, stride),
           *agcn_tconv.tconv_weight_grad(x, dy, stride))
    torch.cuda.synchronize()
    x64, w64, b64, dy64 = (a.double() for a in (x, w, b, dy))
    want = (agcn_tconv.tconv_forward_reference(x64, w64, b64, stride),
            agcn_tconv.tconv_input_grad_reference(dy64, w64, t, stride),
            *agcn_tconv.tconv_weight_grad_reference(x64, dy64, stride))
    for name, g, ref in zip(("y", "dx", "dW", "db"), got, want):
        assert _gap(g, ref) <= FLOOR * float(ref.abs().max()), name


def test_autograd_op_on_card_matches_plain_autograd():
    dev = _card()
    x, w, b, dy = _inputs(24, 16, 16, 2, dev, rows=40)
    leaves = [a.clone().requires_grad_() for a in (x, w, b)]
    (agcn_tconv.temporal_conv9(*leaves, 2) * dy).sum().backward()
    want = [a.double().requires_grad_() for a in (x, w, b)]
    (agcn_tconv.tconv_forward_reference(*want, 2) * dy.double()).sum() \
        .backward()
    for got, ref in zip(leaves, want):
        assert _gap(got.grad, ref.grad) <= FLOOR * float(
            ref.grad.abs().max())


def test_refuses_what_the_kernels_do_not_take():
    dev = _card()
    x = torch.zeros(2, 8, 6, device=dev)
    w6 = torch.zeros(6, 6, 9, 1, device=dev)
    b6 = torch.zeros(6, device=dev)
    with pytest.raises(ValueError, match="multiples of 4"):
        agcn_tconv.tconv_forward(x, w6, b6, 1)
    x4 = torch.zeros(2, 7, 4, device=dev)
    w4 = torch.zeros(4, 4, 9, 1, device=dev)
    b4 = torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="even T"):
        agcn_tconv.tconv_forward(x4, w4, b4, 2)
    with pytest.raises(ValueError, match="stride 3"):
        agcn_tconv.tconv_forward(x4, w4, b4, 3)
    with pytest.raises(TypeError, match="unsupported dtype"):
        agcn_tconv.tconv_forward(x4.double(), w4.double(), b4.double(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        agcn_tconv.tconv_forward(torch.zeros(2, 4, 7, device=dev)
                                 .transpose(1, 2), w4, b4, 1)
    with pytest.raises(ValueError, match=r"\(C_out, C_in, 9, 1\)"):
        agcn_tconv.tconv_forward(x4, torch.zeros(4, 4, 3, 1, device=dev),
                                 b4, 1)


def test_a_published_step_runs_no_cudnn_convolution():
    """The published model's train step: 10 + 10 + 10 launches of the
    conv kernels and, in a profile of it, no cuDNN convolution kernel."""
    dev = _card()
    config = agcn.config_from_args({"num_class": 60, "num_point": 25,
                                    "num_person": 2, "graph": "ntu_rgb_d"})
    model = agcn.Model(config, device=dev).init_weights(
        torch.Generator().manual_seed(0)).train()
    x = torch.randn(2, 3, 32, 25, 2, device=dev)
    kernels.reset_launches()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        model(x).square().sum().backward()
        torch.cuda.synchronize()
    for name in ("agcn_tconv", "agcn_tconv_input_grad",
                 "agcn_tconv_weight_grad"):
        assert kernels.LAUNCHES[name] == 10, name
    names = [e.key for e in prof.key_averages()]
    for pattern in ("dgrad_engine", "wgrad_alg0_engine", "implicit_gemm",
                    "cudnn"):
        assert not any(pattern in n for n in names), (pattern, names)
