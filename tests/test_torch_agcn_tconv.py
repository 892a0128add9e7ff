"""2s-AGCN's 9-tap temporal conv op (``ops/agcn_tconv.py``) on the CPU:
its plain versions against ``F.conv2d`` and autograd through it in
float64 at the published units' shapes (rows cut to 2), gradcheck of
the autograd op, the model through the op against the published forward
pass (``tests/agcn_reference.py``), and the plans and refusals that the
kernels of ``csrc/agcn_tconv.cu`` rely on.  The kernels themselves are
held to the plain versions on the card by
``test_torch_agcn_tconv_card.py``."""

import importlib.util
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from shift_gcn_torch import kernels
from shift_gcn_torch.models import agcn
from shift_gcn_torch.ops import agcn_tconv

HERE = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location(
    "agcn_reference", HERE / "agcn_reference.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

# (T, C, stride) of the published units' convs, and T that no stride
# divides
UNITS = [(300, 64, 1), (300, 128, 2), (150, 128, 1), (150, 256, 2),
         (75, 256, 1)]
ODD = [(75, 16, 2), (151, 8, 1), (9, 12, 2)]


@pytest.fixture(autouse=True)
def no_onednn():
    # torch's oneDNN convolution backward corrupts the heap on the CPU once
    # the reference package's compiled XLA code has run in the same process
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = saved


def _inputs(rows, t, cin, cout, stride, seed=0):
    gen = torch.Generator().manual_seed(seed + t + cin)
    x = torch.randn(rows, t, cin, generator=gen, dtype=torch.float64)
    w = torch.randn(cout, cin, 9, 1, generator=gen, dtype=torch.float64)
    b = torch.randn(cout, generator=gen, dtype=torch.float64)
    dy = torch.randn(rows, agcn_tconv.out_frames(t, stride), cout,
                     generator=gen, dtype=torch.float64)
    return x, w, b, dy


def _conv2d(x, w, b, stride):
    """nn.Conv2d's (9, 1) conv on the (R, C, T, 1) view, back to (R, T,
    C)."""
    y = F.conv2d(x.transpose(1, 2).unsqueeze(-1), w, b, stride=(stride, 1),
                 padding=(4, 0))
    return y.squeeze(-1).transpose(1, 2)


@pytest.mark.parametrize("unit", UNITS + ODD, ids=str)
def test_plain_versions_are_conv2d(unit):
    """Forward, dx, dW and db against F.conv2d and autograd through it,
    float64, two rows."""
    t, c, stride = unit
    x, w, b, dy = _inputs(2, t, c, c, stride)
    leaves = [a.clone().requires_grad_() for a in (x, w, b)]
    want = _conv2d(*leaves, stride)
    want.backward(dy)
    got = agcn_tconv.tconv_forward_reference(x, w, b, stride)
    assert got.shape == want.shape == (2, -(-t // stride), c)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)
    dx = agcn_tconv.tconv_input_grad_reference(dy, w, t, stride)
    dw, db = agcn_tconv.tconv_weight_grad_reference(x, dy, stride)
    for name, g, r in (("dx", dx, leaves[0].grad), ("dW", dw, leaves[1].grad),
                       ("db", db, leaves[2].grad)):
        assert g.shape == r.shape, name
        assert torch.allclose(g, r, rtol=1e-12, atol=1e-11), name


@pytest.mark.parametrize("shape", [(2, 12, 4, 8, 1), (2, 12, 8, 4, 2),
                                   (1, 7, 4, 4, 2)], ids=str)
def test_autograd_op_gradcheck(shape):
    rows, t, cin, cout, stride = shape
    x, w, b, _ = _inputs(rows, t, cin, cout, stride)
    assert torch.autograd.gradcheck(
        lambda *a: agcn_tconv.temporal_conv9(*a, stride),
        [a.requires_grad_() for a in (x, w, b)])


def test_raw_launchers_run_the_plain_versions_on_cpu():
    x, w, b, dy = _inputs(3, 10, 4, 8, 2)
    kernels.reset_launches()
    assert torch.equal(agcn_tconv.tconv_forward(x, w, b, 2),
                       agcn_tconv.tconv_forward_reference(x, w, b, 2))
    assert torch.equal(agcn_tconv.tconv_input_grad(dy, w, 10, 2),
                       agcn_tconv.tconv_input_grad_reference(dy, w, 10, 2))
    for got, want in zip(agcn_tconv.tconv_weight_grad(x, dy, 2),
                         agcn_tconv.tconv_weight_grad_reference(x, dy, 2)):
        assert torch.equal(got, want)
    assert all(count == 0 for count in kernels.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="grad mode"):
        agcn_tconv.tconv_forward(x.requires_grad_(), w, b, 2)


def test_model_runs_its_tcn_through_the_op(monkeypatch):
    """The 2s-AGCN model at a small size against the published forward
    pass, logits, loss and every leaf's gradient, with each unit's 9-tap
    conv going through the op and no conv2d in the model."""
    blocks = [[3, 8, 1, False], [8, 16, 2, True], [16, 16, 1, True]]
    model = agcn.Model(agcn.config_from_args(
        {"num_class": 5, "num_point": 25, "num_person": 2,
         "graph": "ntu_rgb_d", "blocks": blocks}), device="cpu").double()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen,
                                dtype=torch.float64) * 0.5)
    model.train()
    x = torch.randn(2, 3, 16, 25, 2, generator=gen, dtype=torch.float64)
    y = torch.randint(0, 5, (2,), generator=gen)
    w = {k: v.detach().clone().requires_grad_(v.is_floating_point())
         for k, v in model.state_dict().items()}
    want = ref.forward(w, x, True, blocks=blocks)

    calls = []
    apply = agcn_tconv.TemporalConv9Function.apply

    def counted(*args):
        calls.append(args[3])
        return apply(*args)

    monkeypatch.setattr(agcn_tconv.TemporalConv9Function, "apply", counted)
    monkeypatch.setattr(F, "conv2d", None)  # the model calls none
    logits = model(x)
    monkeypatch.undo()
    assert calls == [1, 2, 1]
    scale = float(want.detach().abs().max())
    assert float((logits - want).detach().abs().max()) <= 1e-10 * scale
    F.cross_entropy(logits, y).backward()
    F.cross_entropy(want, y).backward()
    norms = {n: float(w[n].grad.norm()) for n, _ in model.named_parameters()}
    median = sorted(norms.values())[len(norms) // 2]
    for name, p in model.named_parameters():
        err = float((p.grad - w[name].grad).norm())
        assert err <= 1e-10 * max(norms[name], median), name


# ---------------------------------------------------------------------------
# what the kernels rely on: plans, splits and refusals
# ---------------------------------------------------------------------------


def _windows_of(plan, rows):
    """Every block's window of q rows, as the kernels compute it."""
    reach = 4 if plan.npar == 2 else 8
    total = rows * plan.tu

    def q(u):
        return (u // plan.tu) * plan.period + plan.sstride * (u % plan.tu)

    for u0 in range(0, total, plan.bu):
        last = min(u0 + plan.bu, total) - 1
        yield q(last) + reach + 1 - q(u0)


@pytest.mark.parametrize("shape", [
    (3200, 300, 64, 64, 1), (3200, 300, 128, 128, 2),
    (3200, 150, 128, 128, 1), (3200, 150, 256, 256, 2),
    (3200, 75, 256, 256, 1), (8, 16, 64, 64, 1), (8, 8, 256, 256, 2),
    (8, 4, 256, 256, 1), (70, 4, 20, 132, 2), (5, 33, 16, 32, 1)],
    ids=str)
@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "dx"])
def test_plan_holds_every_blocks_window(shape, backward):
    """Each block's window of source rows fits the plan's slab, the
    block's shared memory fits the card, and the positions a block are
    what its warps cover."""
    rows, t, cin, cout, stride = shape
    plan = agcn_tconv.tconv_plan(rows, t, cin, cout, stride, backward)
    assert max(_windows_of(plan, rows)) <= plan.slab_rows
    assert plan.smem <= agcn_tconv.SMEM_LIMIT
    assert plan.bu % 64 == 0
    assert plan.bu <= 64 * (8 // (plan.bn // 64)) // plan.npar
    ndim = cin if backward else cout
    assert plan.nt8 * 8 >= ndim and plan.nt8 * 8 % plan.bn == 0
    if backward and stride == 2:
        assert (plan.tu, plan.taps, plan.npar, plan.pad) == (t // 2, 5, 2, 2)
    else:
        assert (plan.taps, plan.npar, plan.pad) == (9, 1, 4)
        assert plan.tu == (t if backward else -(-t // stride))


def test_plan_takes_the_published_units_with_their_largest_blocks():
    for t, c, stride in UNITS:
        for backward in (False, True):
            plan = agcn_tconv.tconv_plan(3200, t, c, c, stride, backward)
            assert plan.bn == (64 if c == 64 else 128)
            assert plan.bu == 64 * (8 // (plan.bn // 64)) // plan.npar


@pytest.mark.parametrize("c", [64, 128, 256])
def test_weight_grad_scratch_stays_small(c):
    """The splits cover every row group once and keep the partials under
    64 MB at the published widths, N'V = 3200."""
    splits, per = agcn_tconv.weight_grad_splits(3200, c, c)
    groups = 3200 // agcn_tconv.WG_ROWS
    assert (splits - 1) * per < groups <= splits * per
    assert 4 * splits * (c * c * 9 + c) < 64 * 2 ** 20


@pytest.mark.parametrize("args, error, match", [
    ((8, 10, 6, 8, 1), ValueError, "multiples of 4"),
    ((8, 10, 8, 8, 3), ValueError, "stride 3"),
    ((8, 11, 8, 8, 2), ValueError, "even T"),
    ((0, 10, 8, 8, 1), ValueError, "no grid"),
], ids=["channels", "stride", "odd-T", "rows"])
def test_plan_refuses_what_the_kernels_do_not_take(args, error, match):
    with pytest.raises(error, match=match):
        agcn_tconv.tconv_plan(*args, backward=False)


def test_launchers_refuse_a_tensor_off_the_cpu_without_falling_back():
    """A tensor on another device than the CPU goes to the kernels or is
    refused, never to the plain version or another library: on the meta
    device each launcher raises before launching."""
    x = torch.zeros(2, 8, 4, device="meta")
    w = torch.zeros(4, 4, 9, 1, device="meta")
    b = torch.zeros(4, device="meta")
    dy = torch.zeros(2, 8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        agcn_tconv.tconv_forward(x, w, b, 1)
    with pytest.raises(ValueError, match="unsupported device meta"):
        agcn_tconv.tconv_input_grad(dy, w, 8, 1)
    with pytest.raises(ValueError, match="unsupported device meta"):
        agcn_tconv.tconv_weight_grad(x, dy, 1)
    with pytest.raises(ValueError, match="multiples of 4"):
        agcn_tconv.tconv_forward(torch.zeros(2, 8, 6, device="meta"),
                                 torch.zeros(4, 6, 9, 1, device="meta"), b, 1)
    with pytest.raises(ValueError, match=r"\(C_out, C_in, 9, 1\)"):
        agcn_tconv.tconv_forward(x, torch.zeros(4, 4, 3, 1, device="meta"),
                                 b, 1)
