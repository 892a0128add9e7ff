"""The port's Shift-GCN at the NTU-60 shapes (the ``ntu_rgb_d`` graph,
V=25 joints, M=2 persons) against the reference package on the CPU: a
reduced backbone's eval forward and one SGD step, the reference's Pallas
kernels in interpret mode, on the same weights and batch."""

import dataclasses
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_tpu.ops.lowering import Lowering
from shift_gcn_tpu.train import config as jax_config
from shift_gcn_tpu.train import state as jax_state
from shift_gcn_tpu.train.optim import (
    build_weight_decay_tree, init_sgd, sgd_update)
from shift_gcn_torch.models.shift_gcn import Model, config_from_reference_args
from shift_gcn_torch.train import config, optim, state
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

tsk = importlib.import_module(
    "shift_gcn_tpu.ops.pallas.temporal_shift_kernel")
sgk = importlib.import_module("shift_gcn_tpu.ops.pallas.shift_gcn_kernel")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NTU_CONFIGS = [os.path.join(REPO, "configs", split, "train_joint.yaml")
               for split in ("nturgbd-cross-subject", "nturgbd-cross-view")]
# the NTU-60 model_args with a 3-unit backbone: a down conv (3->8, no
# residual), a stride-2 unit with a residual conv (8->16), an identity
# residual
ARGS = {"num_class": 60, "num_point": 25, "num_person": 2,
        "graph": "ntu_rgb_d",
        "blocks": [[3, 8, 1, False], [8, 16, 2], [16, 16]]}
LR = 0.1


@pytest.fixture(scope="module", autouse=True)
def no_onednn():
    # torch's oneDNN convolution backward corrupts the heap on the CPU once
    # the reference package's compiled XLA code has run in the same process
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = saved


@pytest.fixture(scope="module")
def interpret():
    saved = tsk._INTERPRET, sgk._INTERPRET
    tsk._INTERPRET = sgk._INTERPRET = True
    yield
    tsk._INTERPRET, sgk._INTERPRET = saved


@pytest.mark.parametrize("path", NTU_CONFIGS,
                         ids=lambda p: p.split(os.sep)[-2])
def test_ntu_configs_build_the_reference_model(path):
    got = config.load_config(["--config", path])
    want = jax_config.load_config(["--config", path])
    assert got.model_args == want.model_args
    assert (got.batch_size, got.test_batch_size) == (64, 64)
    cfg = config_from_reference_args(got.model_args)
    ref = jax_model.config_from_reference_args(want.model_args)
    assert (cfg.num_class, cfg.num_point, cfg.num_person, cfg.graph) == (
        ref.num_class, ref.num_point, ref.num_person, ref.graph) == (
        60, 25, 2, "ntu_rgb_d")
    assert [(b.in_channels, b.out_channels, b.stride, b.residual)
            for b in cfg.blocks] == [
        (b.in_channels, b.out_channels, b.stride, b.residual)
        for b in ref.blocks]


def _jax_cfg():
    return dataclasses.replace(
        jax_model.config_from_reference_args(ARGS), use_pallas=True,
        lowering=Lowering(tshift_impl="pallas"))


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_arrays(tree, {}).items()
            if not k.endswith(("shift_in", "shift_out"))}


@pytest.mark.parametrize("seed", [0, 1])
def test_ntu_shapes_forward_and_step_match_reference(interpret, seed):
    cfg = _jax_cfg()
    ts = jax_state.create_train_state(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map(np.asarray, ts.params)
    bn_state = jax.tree_util.tree_map(np.asarray, ts.bn_state)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 3, 32, 25, 2)).astype(np.float32)
    labels = rng.integers(0, 60, 4).astype(np.int32)

    model = Model(config_from_reference_args(ARGS), device="cpu")
    model.load_state_dict(state_dict_from_arrays(params, bn_state),
                          strict=True)
    # eval: fp32 through 3 units, another summation order: 1e-5 of scale
    want_eval, _ = jax_model.apply(ts.params, ts.bn_state, jnp.asarray(x),
                                   cfg, training=False)
    with torch.no_grad():
        got_eval = model(torch.from_numpy(x)).numpy()
    scale = max(1.0, float(np.abs(np.asarray(want_eval)).max()))
    np.testing.assert_allclose(got_eval, np.asarray(want_eval), rtol=0,
                               atol=1e-5 * scale)

    def loss_fn(p):
        logits, new_bn = jax_model.apply(p, ts.bn_state, x, cfg,
                                         training=True)
        return jax_state.cross_entropy(logits, labels), new_bn

    (loss, new_bn), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(ts.params)
    new_params, _ = sgd_update(ts.params, grads, init_sgd(ts.params),
                               jnp.float32(LR),
                               build_weight_decay_tree(ts.params))
    opt = optim.build_optimizer(model, LR)
    got_loss, _ = state.train_step(
        model, opt, {"data": torch.from_numpy(x),
                     "label": torch.from_numpy(labels).long()}, LR)
    assert abs(float(got_loss) - float(loss)) <= 1e-5 * max(1.0, float(loss))
    # the one-step envelope of tests/test_torch_train.py: true gradients
    # within 1e-5 + 2e-4 of scale, the ypos steps bit-equal, xpos's zero
    want_g = _flat(jax.tree_util.tree_map(np.asarray, grads))
    got_g = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got_g) == set(want_g)
    for name, w in want_g.items():
        if name.endswith("xpos"):
            assert not got_g[name].any(), name
        elif name.endswith("ypos"):
            np.testing.assert_array_equal(got_g[name], w, err_msg=name)
        else:
            np.testing.assert_allclose(
                got_g[name], w, rtol=0,
                atol=1e-5 + 2e-4 * float(np.abs(w).max()), err_msg=name)
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    for name, w in _flat(jax.tree_util.tree_map(np.asarray,
                                                new_params)).items():
        tol = 1e-6 + 0.19 * (1e-5 + 2e-4 * float(np.abs(want_g[name]).max()))
        np.testing.assert_allclose(sd[name], w, rtol=0, atol=tol,
                                   err_msg=name)
    stats = state_dict_from_arrays({}, jax.tree_util.tree_map(np.asarray,
                                                              new_bn))
    for name, w in stats.items():
        np.testing.assert_allclose(sd[name], w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
