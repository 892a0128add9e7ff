"""2s-AGCN's adjacency kernels (``csrc/adaptive.cu``) against their plain
versions, and the ``agcn2s`` model on the card against its CPU path; each
test skips on a machine without a CUDA card.  Run on the card with
``python -m pytest --noconftest tests/test_torch_agcn_card.py`` (the
suite's conftest sets up JAX, which this file does not use)."""

import pytest
import torch

from shift_gcn_torch import kernels
from shift_gcn_torch.models import agcn
from shift_gcn_torch.ops import adaptive

# fp32 sums over d*T products (forward) and V products (backward) in
# another order than the plain version's matmuls: a few ulps of the
# largest value, amplified by the softmax's exponent
TOL = 2e-5

# (N', V, T, K, d): the least d (4), MediaPipe's 33 joints (more shared
# memory than 48 KB), V and T that no tile or stage divides, and the
# published units' shapes at batch 64 (N' = 128): d = 16 at T = 300,
# d = 32 at T = 300 and 150, d = 64 at T = 150 and 75
SHAPES = [(4, 25, 16, 3, 4), (6, 33, 20, 3, 4), (3, 7, 9, 2, 8),
          (128, 25, 300, 3, 16), (128, 25, 300, 3, 32),
          (128, 25, 150, 3, 32), (128, 25, 150, 3, 64),
          (128, 25, 75, 3, 64)]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda", 0)


def _close(got, want, what):
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    assert err <= TOL * scale, f"{what}: max|err| {err:.3g} of {scale:.3g}"


def _inputs(shape, dev, gain=3.0):
    n, v, t, k, d = shape
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    e = torch.randn(n, v, t, 2 * k * d, generator=gen, device=dev) * gain
    a = torch.rand(k, v, v, generator=gen, device=dev)
    pa = torch.randn(k, v, v, generator=gen, device=dev) * 0.1
    dg = torch.randn(n, k, v, v, generator=gen, device=dev)
    return e, a, pa, dg


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_adjacency_kernels_match_plain(shape):
    dev = _card()
    e, a, pa, dg = _inputs(shape, dev)
    k = shape[3]
    kernels.reset_launches()
    g, p = adaptive.adjacency_forward(e, a, pa, k)
    g2, p2 = adaptive.adjacency_forward(e, a, pa, k)
    torch.cuda.synchronize()
    assert torch.equal(g, g2) and torch.equal(p, p2)
    want_g, want_p = adaptive.adjacency_forward_reference(e, a, pa, k)
    _close(p, want_p, "P")
    _close(g, want_g, "G")
    # the kernel's softmax runs over source joints
    assert torch.allclose(p.sum(2), torch.ones_like(p[:, :, 0]), atol=1e-5)
    de = adaptive.adjacency_backward(e, p, dg)
    de2 = adaptive.adjacency_backward(e, p, dg)
    torch.cuda.synchronize()
    assert torch.equal(de, de2)
    _close(de, adaptive.adjacency_backward_reference(e, want_p, dg), "de")
    assert kernels.LAUNCHES["agcn_adjacency"] == 2
    assert kernels.LAUNCHES["agcn_adjacency_backward"] == 2


def test_adjacency_op_gradients_on_card():
    """The autograd op's de and dPA against autograd through the plain
    version, on the card."""
    dev = _card()
    e, a, pa, dg = _inputs((8, 25, 24, 3, 8), dev)
    e.requires_grad_(True)
    pa.requires_grad_(True)
    (adaptive.agcn_adjacency(e, a, pa, 3) * dg).sum().backward()
    got = e.grad.clone(), pa.grad.clone()
    e.grad, pa.grad = None, None
    g, _ = adaptive.adjacency_forward_reference(e, a, pa, 3)
    (g * dg).sum().backward()
    _close(got[0], e.grad, "de")
    _close(got[1], pa.grad, "dPA")


def test_adjacency_refuses_what_the_kernels_do_not_take():
    dev = _card()
    e = torch.zeros(2, 65, 4, 6, device=dev)
    a = torch.zeros(1, 65, 65, device=dev)
    with pytest.raises(ValueError, match="65 joints"):
        adaptive.adjacency_forward(e, a, a, 1)
    e6 = torch.zeros(2, 25, 4, 12, device=dev)
    a25 = torch.zeros(1, 25, 25, device=dev)
    with pytest.raises(ValueError, match="d=6"):
        adaptive.adjacency_forward(e6, a25, a25, 1)
    e64 = torch.zeros(2, 25, 4, 8, dtype=torch.float64, device=dev)
    a64 = torch.zeros(1, 25, 25, dtype=torch.float64, device=dev)
    with pytest.raises(TypeError, match="unsupported dtype"):
        adaptive.adjacency_forward(e64, a64, a64, 1)


def _model(blocks, device, seed=0):
    config = agcn.config_from_args({"num_class": 7, "num_point": 25,
                                    "num_person": 2, "graph": "ntu_rgb_d",
                                    "blocks": blocks})
    model = agcn.Model(config, device=device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return model.train()


def test_model_on_card_matches_cpu_path():
    """A 3-unit model: logits and every leaf's gradient on the card (the
    kernels) against the CPU path (the plain versions), same weights."""
    dev = _card()
    blocks = [[3, 16, 1, False], [16, 32, 2, True], [32, 32, 1, True]]
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 3, 32, 25, 2, generator=gen)
    y = torch.randint(0, 7, (4,), generator=gen)
    out = {}
    for device in ("cpu", dev):
        model = _model(blocks, device)
        logits = model(x.to(device))
        torch.nn.functional.cross_entropy(logits, y.to(device)).backward()
        out[str(device)] = (logits.detach().cpu(),
                            {n: p.grad.cpu()
                             for n, p in model.named_parameters()})
    (cpu_logits, cpu_grads), (card_logits, card_grads) = out.values()
    _close(card_logits, cpu_logits, "logits")
    median = torch.stack([g.norm() for g in cpu_grads.values()]).median()
    for name, g in cpu_grads.items():
        err = float((card_grads[name] - g).norm())
        # leaves whose gradient is round-off (biases ahead of a BN, the
        # embeddings' a-bias under the source softmax) against the median
        assert err <= 1e-3 * max(float(g.norm()), float(median)), name


def test_launches_per_step_at_the_published_depth():
    """One forward and one backward launch per unit: 10 and 10 a step."""
    dev = _card()
    model = _model([list(b) for b in agcn.PUBLISHED_BLOCKS], dev)
    x = torch.randn(2, 3, 16, 25, 2, device=dev)
    kernels.reset_launches()
    model(x).square().sum().backward()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["agcn_adjacency"] == 10
    assert kernels.LAUNCHES["agcn_adjacency_backward"] == 10
