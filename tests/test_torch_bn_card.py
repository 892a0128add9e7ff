"""Train-mode BN's kernels (``csrc/batchnorm.cu``) against their plain
versions on a CUDA card, at small shapes; each test skips on a machine
without one.  ``chip_smoke.py`` phase 25 runs the same checks at the
models' shapes.  Run on the card with
``python -m pytest --noconftest tests/test_torch_bn_card.py`` (the
suite's conftest sets up JAX, which this file does not use)."""

import pytest
import torch

from shift_gcn_torch import kernels
from shift_gcn_torch.ops import batchnorm

# fp32: the kernels' sums in another order than torch's; 16-bit outputs:
# one rounding of the same fp32 value may land on the neighbouring value
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7, torch.float16: 2 ** -10}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def _close(got, want, tol, what):
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    assert err <= tol * scale, f"{what}: max|err| {err:.3g}"


# (shape, feature_dims, offset): the tcn, Shift_gcn and data_bn layouts,
# F not a multiple of a vector, and x one element into its storage (the
# one-element runs)
CASES = [((4, 30, 33, 64), 1, 0), ((4, 30, 33, 64), 2, 0),
         ((4, 30, 99), 1, 0), ((2, 7, 5, 3), 1, 0), ((4, 30, 33, 64), 1, 1)]


@pytest.mark.parametrize("shape,fd,offset", CASES,
                         ids=[f"{s}-{fd}-{o}" for s, fd, o in CASES])
@pytest.mark.parametrize("dtype", list(TOL), ids=str)
def test_batch_norm_train_kernels_match_plain(shape, fd, offset, dtype):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    n = int(torch.tensor(shape).prod())
    x = (torch.randn(n + offset, generator=gen, device=dev) * 2 + 0.5).to(
        dtype)[offset:].view(shape)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
    f = int(torch.tensor(shape[len(shape) - fd:]).prod())
    w = torch.rand(f, generator=gen, device=dev) + 0.5
    b = torch.randn(f, generator=gen, device=dev)

    def forward(launcher, lp):
        state = (torch.zeros(f, device=dev), torch.ones(f, device=dev),
                 torch.zeros((), dtype=torch.long, device=dev))
        return launcher(x, w, b, *state, feature_dims=fd, lp=lp) + state

    for lp in (False, True):
        kernels.reset_launches()
        got = forward(batchnorm.batch_norm_train_forward, lp)
        again = forward(batchnorm.batch_norm_train_forward, lp)
        want = forward(batchnorm.batch_norm_train_forward_reference, lp)
        assert kernels.LAUNCHES["batch_norm_train"] == 2
        for a, c in zip(got, again):
            assert torch.equal(a, c)
        _close(got[0], want[0], TOL[dtype], "y")
        for k, (a, c) in enumerate(zip(got[1:4], want[1:4])):
            _close(a, c, 1e-5, f"statistics {k}")
        assert int(got[4]) == int(want[4]) == 1
    dx, dw, db = batchnorm.batch_norm_train_backward(x, dy, got[1], w,
                                                     feature_dims=fd)
    again = batchnorm.batch_norm_train_backward(x, dy, got[1], w,
                                                feature_dims=fd)
    for a, c in zip((dx, dw, db), again):
        assert torch.equal(a, c)
    pdx, pdw, pdb = batchnorm.batch_norm_train_backward_reference(
        x, dy, got[1], w, feature_dims=fd)
    _close(dx, pdx, TOL[dtype], "dx")
    # fp32 sums in another order: within 1e-5 of the sum of |terms|
    mean, inv = got[1].unbind(0)
    g = dy.float().reshape(-1, f)
    xhat = (x.float().reshape(-1, f) - mean) * inv
    for name, a, c, terms in (("dw", dw, pdw, g * xhat), ("db", db, pdb, g)):
        bound = 1e-5 * terms.abs().sum(0)
        assert bool(((a - c).abs() <= bound).all()), name
    assert kernels.LAUNCHES["batch_norm_train_backward"] == 2


def test_batch_norm_train_refuses_float64_on_card():
    dev = _card()
    x = torch.zeros(4, 3, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="unsupported dtype"):
        batchnorm.batch_norm_train_forward(
            x, torch.ones(3, device=dev), torch.zeros(3, device=dev),
            torch.zeros(3, device=dev), torch.ones(3, device=dev),
            torch.zeros((), dtype=torch.long, device=dev))
