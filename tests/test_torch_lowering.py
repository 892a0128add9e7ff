"""The port's lowering knobs (shift_gcn_torch.ops.lowering) against the
reference package on the CPU: the config surface (from_dict, validation,
SGT_* overrides), and the four knobs that change numerics: exact_xpos
(the joint-axis pass), max_shift (the shift range), bn_lp / bn_lp_eval
(the low-precision BN normalize) and compute_dtype (the 1x1 convs' matmul
inputs), on the same inputs and weights."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_tpu.ops import batchnorm as jax_bn
from shift_gcn_tpu.ops import lowering as jax_lowering
from shift_gcn_tpu.ops.temporal_shift import temporal_shift as jax_tshift
from shift_gcn_tpu.train import state as jax_state
from shift_gcn_torch.models.shift_gcn import Model, config_from_reference_args
from shift_gcn_torch.ops import batchnorm, lowering
from shift_gcn_torch.ops import temporal_shift as ts
from shift_gcn_torch.train import state
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

tsk = importlib.import_module(
    "shift_gcn_tpu.ops.pallas.temporal_shift_kernel")
sgk = importlib.import_module("shift_gcn_tpu.ops.pallas.shift_gcn_kernel")

# 3 units: a down conv (3->8, no residual), a stride-2 unit with a residual
# conv (8->16), an identity residual; 2 persons
ARGS = {"num_class": 5, "num_point": 33, "num_person": 2,
        "graph": "mediapipe_pose",
        "blocks": [[3, 8, 1, False], [8, 16, 2], [16, 16]]}


@pytest.fixture(scope="module", autouse=True)
def no_onednn():
    # torch's oneDNN convolution backward corrupts the heap on the CPU once
    # the reference package's compiled XLA code has run in the same process
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = saved


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(tsk, "_INTERPRET", True)
    monkeypatch.setattr(sgk, "_INTERPRET", True)


@pytest.fixture
def clean_env(monkeypatch):
    for var, _ in jax_lowering._ENV.values():
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# The config surface
# ---------------------------------------------------------------------------

CASES = [
    {},
    {"exact_xpos": True, "max_shift": 12},
    {"bn_lp": "yes", "bn_lp_eval": "off", "max_shift": "16"},
    {"tshift_impl": "conv", "sgcn_impl": "chain", "sshift_impl": "roll",
     "tcn_fuse": 1, "tcn_freq_fuse": 1, "tcn_bnfold": "true"},
    {"bn_lp": "maybe"},
    {"tshift_impl": "dtf"},
    {"tcn_freq_fuse": "sometimes"},
    {"max_shift": 0},
    {"no_such_knob": 1, "other": 2},
]


@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_from_dict_matches_reference(case):
    try:
        want = jax_lowering.as_dict(jax_lowering.from_dict(case))
    except (KeyError, ValueError) as err:
        with pytest.raises(type(err)) as got:
            lowering.from_dict(case)
        assert str(got.value) == str(err)
        return
    assert lowering.as_dict(lowering.from_dict(case)) == want


def test_validate_raises_on_construction():
    for bad in ({"tshift_impl": "fft"}, {"sgcn_impl": "x"},
                {"sshift_impl": "x"}, {"max_shift": -1}):
        with pytest.raises(ValueError) as want:
            jax_lowering.Lowering(**bad)
        with pytest.raises(ValueError) as got:
            lowering.Lowering(**bad)
        assert str(got.value) == str(want.value)
    low = lowering.Lowering(exact_xpos=True)
    assert not low.xpos_zero and low.validate() is low


ENVS = [
    {},
    {"SGT_MAX_SHIFT": "12", "SGT_BN_LP_EVAL": "0", "SGT_EXACT_XPOS": "1"},
    {"SGT_BN_LP": "1", "SGT_BN_LP_EVAL": "yes", "SGT_TCN_FUSE": "true"},
    {"SGT_TSHIFT_IMPL": "conv", "SGT_TCN_FREQ_FUSE": "0",
     "SGT_EXACT_XPOS": "0"},
    {"SGT_TSHIFT_IMPL": "bogus"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_env_overrides_resolve_as_reference(clean_env, env):
    # precedence: environment > config > default
    for var, value in env.items():
        clean_env.setenv(var, value)
    base = {"max_shift": 10, "bn_lp": True, "tshift_impl": "slice"}
    assert lowering.env_overrides() == jax_lowering.env_overrides()
    try:
        want = jax_lowering.as_dict(jax_lowering.resolve(
            jax_lowering.from_dict(base)))
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err).split(":")[0]):
            lowering.resolve(lowering.from_dict(base))
        return
    assert lowering.as_dict(lowering.resolve(
        lowering.from_dict(base))) == want
    assert lowering.as_dict(lowering.resolve()) == jax_lowering.as_dict(
        jax_lowering.resolve())


# ---------------------------------------------------------------------------
# exact_xpos: the joint-axis pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stride", [1, 2])
def test_exact_xpos_shift_matches_reference_conv_lowering(stride):
    # The port runs the 3-tap joint pass, then the 2-tap temporal shift;
    # the reference one 2-D tap conv.  Same function, another rounding
    # order: measured over 4 seeds a stride, the gaps are at most 1.6e-7
    # of scale (forward and grad_input); held at 1e-5.  The position steps are bit-equal (every
    # |gy_raw| is far from a tie at these random inputs).
    rng = np.random.default_rng(stride)
    n, t, v, c = 3, 24, 33, 16
    x = rng.standard_normal((n, t, v, c)).astype(np.float32)
    xpos = rng.uniform(-0.9, 0.9, c).astype(np.float32)
    xpos[:3] = (0.9, -0.9, 0.0)
    ypos = rng.uniform(-3.0, 3.0, c).astype(np.float32)
    g = rng.standard_normal((n, t // stride, v, c)).astype(np.float32)
    low = jax_lowering.Lowering(exact_xpos=True, tshift_impl="conv")

    out, vjp = jax.vjp(lambda a, b, d: jax_tshift(a, b, d, stride, low),
                       jnp.asarray(x), jnp.asarray(xpos), jnp.asarray(ypos))
    want_dx, want_dxpos, want_dypos = (np.asarray(a) for a in
                                       vjp(jnp.asarray(g)))

    xt = torch.from_numpy(x).requires_grad_()
    xpos_t = torch.from_numpy(xpos).requires_grad_()
    ypos_t = torch.from_numpy(ypos).requires_grad_()
    got = ts.temporal_shift(xt, ypos_t, stride, xpos=xpos_t, exact_xpos=True)
    got.backward(torch.from_numpy(g))

    scale = float(np.abs(np.asarray(out)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               rtol=0, atol=1e-5 * scale)
    dscale = float(np.abs(want_dx).max())
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=0,
                               atol=1e-5 * dscale)
    np.testing.assert_array_equal(ypos_t.grad.numpy(), want_dypos)
    assert not xpos_t.grad.any() and not want_dxpos.any()
    # the knob selects something: xpos at +-0.9 moves the output
    plain = ts.temporal_shift(torch.from_numpy(x), torch.from_numpy(ypos),
                              stride)
    assert float((plain - got.detach()).abs().max()) > 0.1 * scale


def test_joint_pass_reads_xpos_detached():
    x = torch.randn(2, 8, 5, 4, requires_grad=True)
    xpos = torch.full((4,), 0.5, requires_grad=True)
    out = ts.joint_pass(x, xpos.detach())
    assert not out.requires_grad or out.grad_fn is not None
    out.sum().backward()
    assert xpos.grad is None
    # interpolation halfway to the next joint, zero past the last joint
    want = 0.5 * (x[:, :, :4] + x[:, :, 1:])
    torch.testing.assert_close(out[:, :, :4], want, rtol=0, atol=1e-6)
    torch.testing.assert_close(out[:, :, 4], 0.5 * x[:, :, 4], rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Reduced models against the reference's apply
# ---------------------------------------------------------------------------


def _arrays(cfg, seed, ypos_bound=1.0):
    """Reference init with non-trivial BN statistics and affine, and every
    ypos drawn from U(-ypos_bound, ypos_bound)."""
    params, bn_state = jax_model.init_params(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map(np.array, params)
    bn_state = jax.tree_util.tree_map(np.array, bn_state)
    rng = np.random.default_rng(seed)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                if set(v) == {"weight", "bias"} and v["weight"].ndim == 1:
                    v["weight"] = rng.uniform(0.5, 1.5, v["weight"].shape
                                              ).astype(np.float32)
                    v["bias"] = rng.normal(0, 0.2, v["bias"].shape
                                           ).astype(np.float32)
                else:
                    walk(v)
            elif k == "running_mean":
                tree[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
            elif k == "running_var":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "ypos":
                tree[k] = rng.uniform(-ypos_bound, ypos_bound, v.shape
                                      ).astype(np.float32)

    walk(params)
    walk(bn_state)
    return params, bn_state


def _jax_cfg(low, **overrides):
    cfg = jax_model.config_from_reference_args(ARGS)
    return dataclasses.replace(cfg, lowering=low, **overrides)


def _port(params, bn_state, low_dict=None, **overrides):
    args = dict(ARGS, lowering=low_dict) if low_dict else ARGS
    cfg = dataclasses.replace(config_from_reference_args(args), **overrides)
    model = Model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_arrays(params, bn_state),
                          strict=True)
    return model


def _jax_step(cfg, params, bn_state, x, labels):
    """(logits, loss, grads as a port-named dict) of one reference train
    forward and backward."""
    def loss_fn(p):
        logits, _ = jax_model.apply(p, bn_state, x, cfg, training=True)
        return jax_state.cross_entropy(logits, labels), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, params))
    flat = {k: v.numpy() for k, v in state_dict_from_arrays(
        jax.tree_util.tree_map(np.asarray, grads), {}).items()
        if not k.endswith(("shift_in", "shift_out"))}
    return np.asarray(logits), float(loss), flat


def _port_step(model, x, labels):
    model.train()
    model.zero_grad(set_to_none=True)
    logits = model(torch.from_numpy(x))
    loss = state.cross_entropy(logits, torch.from_numpy(labels).long())
    loss.backward()
    return (logits.detach().numpy(), float(loss.detach()),
            {n: p.grad.numpy() for n, p in model.named_parameters()})


def _assert_step(want, got, atol, rtol):
    want_logits, want_loss, want_g = want
    got_logits, got_loss, got_g = got
    scale = float(np.abs(want_logits).max())
    np.testing.assert_allclose(got_logits, want_logits, rtol=0,
                               atol=atol * max(scale, 1.0))
    assert abs(got_loss - want_loss) <= atol * max(1.0, abs(want_loss))
    assert set(got_g) == set(want_g)
    for name, w in want_g.items():
        if name.endswith("xpos"):
            assert not got_g[name].any(), name
        elif name.endswith("ypos"):
            np.testing.assert_array_equal(got_g[name], w, err_msg=name)
        else:
            np.testing.assert_allclose(
                got_g[name], w, rtol=0,
                atol=atol + rtol * float(np.abs(w).max()), err_msg=name)


def _batch(seed, n=2, t=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3, t, 33, 2)).astype(np.float32),
            rng.integers(0, 5, n).astype(np.int32))


def test_exact_xpos_model_matches_reference():
    # the reference's conv temporal lowering with the 2-D taps, its Pallas
    # spatial kernel (interpret mode is not needed: use_pallas off runs its
    # dft spatial lowering, the same function); xpos up to 0.9
    low = jax_lowering.Lowering(exact_xpos=True, tshift_impl="conv")
    cfg = _jax_cfg(low)
    params, bn_state = _arrays(cfg, 3)
    rng = np.random.default_rng(30)
    for block in params.values():
        for shift in ("shift_in", "shift_out"):
            if "tcn1" in block:
                c = block["tcn1"][shift]["xpos"].shape[0]
                block["tcn1"][shift]["xpos"] = rng.uniform(
                    -0.9, 0.9, c).astype(np.float32)
    x, labels = _batch(3)
    want_eval, _ = jax_model.apply(params, bn_state, x, cfg, training=False)
    model = _port(params, bn_state, {"exact_xpos": True})
    assert model.lowering.exact_xpos
    with torch.no_grad():
        got_eval = model(torch.from_numpy(x)).numpy()
    scale = float(np.abs(want_eval).max())
    # fp32 through 3 units, other summation orders: 1e-5 of scale
    np.testing.assert_allclose(got_eval, np.asarray(want_eval), rtol=0,
                               atol=1e-5 * max(scale, 1.0))
    # one train step's gradients: fp32 roundoff of another order, the
    # same envelope as tests/test_torch_train.py's one-step test
    _assert_step(_jax_step(cfg, params, bn_state, x, labels),
                 _port_step(model, x, labels), 1e-5, 2e-4)


def test_max_shift_model_matches_reference(interpret):
    # ypos up to 10 under max_shift 12, the reference's Pallas kernels in
    # interpret mode (their tap window follows max_shift)
    low = jax_lowering.Lowering(tshift_impl="pallas", max_shift=12)
    cfg = _jax_cfg(low, use_pallas=True)
    params, bn_state = _arrays(cfg, 4, ypos_bound=10.0)
    ypos = params["l2"]["tcn1"]["shift_out"]["ypos"]
    ypos[:2] = (10.0, -10.0)
    x, labels = _batch(4)
    model = _port(params, bn_state, {"max_shift": 12})
    assert model.lowering.max_shift == 12
    _assert_step(_jax_step(cfg, params, bn_state, x, labels),
                 _port_step(model, x, labels), 1e-5, 2e-4)
    # the same weights are refused at the default radius, and at 12 once
    # a ypos reaches 11.5
    with pytest.raises(ValueError, match="ypos magnitude .* max_shift=8"):
        _port(params, bn_state)
    ypos[0] = 11.5
    with pytest.raises(ValueError, match="max_shift=12"):
        _port(params, bn_state, {"max_shift": 12})


def test_compute_dtype_model_matches_reference(interpret):
    # The 1x1 convs' inputs rounded to bf16 on both sides, products
    # accumulated in fp32, the gradients of the rounded inputs rounded to
    # bf16 too; K4 and the residual conv ignore it.  A value the two sides
    # round to neighbouring bf16 numbers moves a sum by 2^-8 of one term.
    # Measured over seeds 4-7: eval logits within 1.2e-6 of scale (held at
    # 1e-5); the train step's loss within 2.5e-5 relative, the
    # concatenated true gradient at cosine >= 0.999993 and 0.05-0.36%
    # relative L2 gap, ypos steps equal on >= 99% of channels.  Held at
    # 1e-4, 0.9999, 1% and 95%.
    low = jax_lowering.Lowering(tshift_impl="pallas")
    cfg = _jax_cfg(low, use_pallas=True, compute_dtype="bfloat16")
    params, bn_state = _arrays(cfg, 5)
    x, labels = _batch(5)
    model = _port(params, bn_state, compute_dtype="bfloat16")
    assert model.config.dtype == torch.bfloat16
    want_eval, _ = jax_model.apply(params, bn_state, x, cfg, training=False)
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x)).numpy()
    scale = float(np.abs(want_eval).max())
    np.testing.assert_allclose(got_eval, np.asarray(want_eval), rtol=0,
                               atol=1e-5 * max(scale, 1.0))
    # and it changes the result against fp32 inputs
    fp32 = _port(params, bn_state)
    with torch.no_grad():
        assert float(np.abs(fp32(torch.from_numpy(x)).numpy()
                            - got_eval).max()) > 1e-4 * scale
    _, want_loss, want_g = _jax_step(cfg, params, bn_state, x, labels)
    _, got_loss, got_g = _port_step(model, x, labels)
    assert abs(got_loss - want_loss) <= 1e-4 * abs(want_loss)
    names = [n for n in want_g if not n.endswith(("xpos", "ypos"))]
    got = np.concatenate([got_g[n].ravel() for n in names])
    want = np.concatenate([want_g[n].ravel() for n in names])
    cos = float(got @ want / (np.linalg.norm(got) * np.linalg.norm(want)))
    assert cos >= 0.9999, cos
    assert np.linalg.norm(got - want) <= 0.01 * np.linalg.norm(want)
    steps = [(got_g[n] == want_g[n]).mean() for n in want_g
             if n.endswith("ypos")]
    assert np.mean(steps) >= 0.95, steps
    assert not any(got_g[n].any() for n in got_g if n.endswith("xpos"))


# ---------------------------------------------------------------------------
# bn_lp / bn_lp_eval
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("lp", [True, False])
def test_bn_lp_matches_reference_batch_norm(training, lp):
    # bf16 activations, fp32 statistics.  lp: x * a + b in bf16 on both
    # sides (XLA may keep the product in fp32 before the add: one bf16
    # rounding apart, 2^-7 of scale); not lp: the fp32 normalize rounded
    # once (2^-8).  Running statistics: fp32, 1e-6.
    rng = np.random.default_rng(int(training) * 2 + int(lp))
    c = 16
    x = (rng.standard_normal((4, 10, 33, c)) * 2 + 0.5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    params = {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(0, 0.2, c).astype(np.float32)}
    bn_state = {"running_mean": rng.normal(0, 0.3, c).astype(np.float32),
                "running_var": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "num_batches_tracked": np.asarray(3, np.int32)}
    want, new_state = jax_bn.batch_norm(
        xb, params, bn_state, reduce_axes=(0, 1, 2), training=training,
        lp=lp)
    assert want.dtype == jnp.bfloat16

    bn = batchnorm.BatchNorm(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["weight"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(bn_state["running_mean"]))
        bn.running_var.copy_(torch.from_numpy(bn_state["running_var"]))
    bn.lp_train = bn.lp_eval = lp
    bn.train(training)
    xt = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    got = bn(xt)
    assert got.dtype == torch.bfloat16
    want32 = np.asarray(want.astype(jnp.float32))
    scale = float(np.abs(want32).max())
    np.testing.assert_allclose(got.float().detach().numpy(), want32, rtol=0,
                               atol=(2 ** -7 if lp else 2 ** -8) * scale)
    for key in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(bn, key).numpy(),
                                   np.asarray(new_state[key]), rtol=1e-6,
                                   atol=1e-6)
    # the other setting gives another result
    bn.lp_train = bn.lp_eval = not lp
    other = bn(xt)
    assert not torch.equal(other, got)


def test_model_sets_bn_precision_from_lowering(clean_env):
    model = Model(config_from_reference_args(
        dict(ARGS, lowering={"bn_lp": True, "bn_lp_eval": False})),
        device="cpu")
    bns = [m for m in model.modules() if isinstance(m, batchnorm.BatchNorm)]
    assert bns and all(m.lp_train and not m.lp_eval for m in bns)
    clean_env.setenv("SGT_BN_LP_EVAL", "1")
    model = Model(config_from_reference_args(
        dict(ARGS, lowering={"bn_lp_eval": False})), device="cpu")
    assert all(m.lp_eval and not m.lp_train for m in model.modules()
               if isinstance(m, batchnorm.BatchNorm))
