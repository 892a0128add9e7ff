"""The port's training past the first dither tie, against the reference
package on the CPU (docs/PARITY.md:137-160, modelled on
tests/test_trajectory_parity.py and tests/test_convergence_parity.py).

Lockstep agreement holds only up to the first "dither tie": the ypos
constraint step takes the sign of a sum that sits at fp32 cancellation
scale near equilibrium, so any two fp32 implementations fork there
(docs/PARITY.md).  Past it the claim is statistical:

- a 60-step envelope: the port's train step (``state.train_step`` with
  the port's SGD) and the reference package's jitted step, from the same
  initial weights on the same batches with the reference LR schedule,
  keep their loss curves and positions within the envelope the reference
  package keeps against the reference torch loop;
- to plateau: 600 steps (20 epochs, two-stage LR decay) on a
  non-separable task, then the held-out eval accuracies agree within 0.06
  (fp32) and 0.07 (bf16 activations on both sides).

Slow: a few minutes on the CPU, so it stays out of the fast tier.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shift_gcn_tpu.models.shift_gcn import init_params
from shift_gcn_tpu.train import state as jax_state
from shift_gcn_tpu.train.optim import build_weight_decay_tree
from shift_gcn_torch.models.shift_gcn import BlockSpec, Model, ModelConfig
from shift_gcn_torch.train import optim, state
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

from test_convergence_parity import (
    _EPOCHS, _N_EVAL, _N_TRAIN, _STEPS_PER_EPOCH as _PLATEAU_STEPS,
    _epoch_batches, _lr_for, _make_dataset, _run_jax_to_plateau)
from test_trajectory_parity import (
    _CONFIG, _STEPS_PER_EPOCH, _lr_for_step, _make_batches)

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module", autouse=True)
def no_onednn():
    # as in test_torch_train.py: torch's oneDNN convolution backward
    # corrupts the heap on the CPU once the reference package's compiled
    # XLA code has run in the same process
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = saved


def _port_config(activation_dtype=None):
    return ModelConfig(
        num_class=_CONFIG.num_class, num_point=_CONFIG.num_point,
        num_person=_CONFIG.num_person, graph=_CONFIG.graph,
        blocks=tuple(BlockSpec(b.in_channels, b.out_channels, b.stride,
                               b.residual) for b in _CONFIG.blocks),
        activation_dtype=activation_dtype)


def _port_model(params, bn_state, activation_dtype=None):
    model = Model(_port_config(activation_dtype), device="cpu")
    model.load_state_dict(state_dict_from_arrays(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, bn_state)))
    return model, optim.build_optimizer(model, 0.1)


def _step(model, opt, xb, yb, lr):
    loss, _ = state.train_step(model, opt, {
        "data": torch.from_numpy(xb),
        "label": torch.from_numpy(yb).long()}, lr)
    return float(loss)


def _all_ypos(named):
    """Every shift position, concatenated in state_dict name order, with
    the first unit's input-shift positions first: the trajectory the
    reference package's own envelope is measured on."""
    named = dict(named)
    first = "l1.tcn1.shift_in.ypos"
    return np.concatenate([np.asarray(named[first]).ravel()] + [
        np.asarray(v).ravel() for k, v in sorted(named.items())
        if k.endswith("ypos") and k != first])


def _run_port(params, bn_state, xs, ys, activation_dtype=None):
    model, opt = _port_model(params, bn_state, activation_dtype)
    losses, ypos = [], []
    for step, (xb, yb) in enumerate(zip(xs, ys)):
        losses.append(_step(model, opt, xb, yb, _lr_for_step(step)))
        ypos.append(_all_ypos((k, v.detach().numpy())
                              for k, v in model.named_parameters()))
    return np.asarray(losses), np.asarray(ypos)


def _run_jax(config, params, bn_state, xs, ys):
    """The reference package's jitted step over the batches; losses and
    every shift position after each step."""
    ts = jax_state.TrainState(
        params=params, bn_state=bn_state,
        opt_state=jax_state.init_sgd(params),
        global_step=jnp.zeros((), jnp.int32))
    step_fn = jax.jit(jax_state.make_train_step(
        config, build_weight_decay_tree(params)))
    losses, ypos = [], []
    for step, (xb, yb) in enumerate(zip(xs, ys)):
        ts, metrics = step_fn(
            ts, {"data": jnp.asarray(xb), "label": jnp.asarray(yb)},
            jnp.asarray(_lr_for_step(step), jnp.float32))
        losses.append(float(metrics["loss"]))
        ypos.append(_all_ypos(state_dict_from_arrays(
            jax.tree_util.tree_map(np.asarray, ts.params), {}).items()))
    return np.asarray(losses), np.asarray(ypos)


@pytest.fixture(scope="module")
def envelope():
    params, bn_state = init_params(jax.random.key(11), _CONFIG)
    xs, ys = _make_batches()
    out = {}
    for act in (None, "bfloat16"):
        config = dataclasses.replace(_CONFIG, activation_dtype=act)
        jlosses, jypos = _run_jax(config, params, bn_state, xs, ys)
        plosses, pypos = _run_port(params, bn_state, xs, ys, act)
        out[act or "float32"] = (jlosses, jypos, plosses, pypos)
    return out


# (max step diff, last-quarter mean diff, plateau diff, ypos) bands: the
# reference package's own envelope against the reference torch loop
# (tests/test_trajectory_parity.py), fp32 and bf16
ENVELOPES = {"float32": (0.35, 0.08, 0.05, 0.09),
             "bfloat16": (0.4, 0.12, 0.08, 0.12)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sixty_step_envelope(envelope, dtype):
    jlosses, jypos, plosses, pypos = envelope[dtype]
    max_diff, quarter, plateau, ypos_band = ENVELOPES[dtype]
    assert len(plosses) == len(jlosses) == 4 * _STEPS_PER_EPOCH
    assert np.isfinite(plosses).all()
    d = np.abs(plosses - jlosses)
    assert d.max() < max_diff, d.max()
    assert d[-15:].mean() < quarter, d[-15:].mean()
    assert abs(np.mean(plosses[-5:]) - np.mean(jlosses[-5:])) < plateau
    assert np.mean(plosses[-5:]) < 0.5 * plosses[0]
    assert np.mean(jlosses[-5:]) < 0.5 * jlosses[0]
    # positions move in exact quanta on both sides: a few of them apart
    # (the first unit's input shift, where the band was measured)
    first = _CONFIG.blocks[0].out_channels
    assert np.abs(pypos[:, :first] - jypos[:, :first]).max() <= ypos_band


def test_lockstep_until_the_first_tie(envelope):
    """fp32: every position bit-equal and the losses within 5e-4 up to
    the first tie (the first step after which any position differs),
    which must not come before step 3."""
    jlosses, jypos, plosses, pypos = envelope["float32"]
    diffs = np.abs(jypos - pypos).max(axis=1)
    first_tie = next((i for i in range(len(diffs)) if diffs[i] > 1e-6),
                     len(diffs))
    assert first_tie >= 3, first_tie
    np.testing.assert_allclose(plosses[:first_tie], jlosses[:first_tie],
                               atol=5e-4, rtol=0)


def _run_port_to_plateau(params, bn_state, xtr, ytr, xev, yev,
                         activation_dtype=None):
    model, opt = _port_model(params, bn_state, activation_dtype)
    losses = []
    for epoch in range(_EPOCHS):
        for xb, yb in _epoch_batches(xtr, ytr, epoch):
            losses.append(_step(model, opt, xb, yb, _lr_for(epoch)))
    logits, _, _ = state.eval_step(model, {
        "data": torch.from_numpy(xev), "label": torch.from_numpy(yev)})
    acc = float((logits.argmax(-1).numpy() == yev).mean())
    return np.asarray(losses), acc


@pytest.fixture(scope="module")
def plateau():
    xtr, ytr = _make_dataset(_N_TRAIN, seed=23)
    xev, yev = _make_dataset(_N_EVAL, seed=29)
    params, bn_state = init_params(jax.random.key(11), _CONFIG)
    out = {}
    for act in (None, "bfloat16"):
        config = dataclasses.replace(_CONFIG, activation_dtype=act)
        jlosses, jacc = _run_jax_to_plateau(config, xtr, ytr, xev, yev)
        plosses, pacc = _run_port_to_plateau(params, bn_state, xtr, ytr,
                                             xev, yev, act)
        out[act or "float32"] = (jlosses, jacc, plosses, pacc)
    return out


@pytest.mark.parametrize("dtype, band", [("float32", 0.06),
                                         ("bfloat16", 0.07)])
def test_plateau_accuracy_band(plateau, dtype, band):
    """Held-out accuracy after 600 steps within the reference package's
    bands (its own to-plateau agreement with the reference torch loop):
    the two trainings learn the same, not just start the same."""
    jlosses, jacc, plosses, pacc = plateau[dtype]
    assert abs(pacc - jacc) <= band, (pacc, jacc)
    assert 0.4 < pacc < 0.95, pacc  # learned, and the task is not separable
    first = plosses[:_PLATEAU_STEPS].mean()
    last = plosses[-_PLATEAU_STEPS:].mean()
    assert last < 0.7 * first
    assert abs(last - jlosses[-_PLATEAU_STEPS:].mean()) < 0.1
