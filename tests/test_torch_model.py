"""Port Model (shift_gcn_torch.models.shift_gcn) vs the reference
package's ``apply(training=False)`` on the CPU, with the same weights
carried over through ``state_dict_from_arrays``."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax

from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_tpu.ops.lowering import Lowering
from shift_gcn_tpu.utils.checkpoint import pytrees_to_torch_state_dict
from shift_gcn_torch.models.shift_gcn import Model, config_from_reference_args
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

tsk = importlib.import_module(
    "shift_gcn_tpu.ops.pallas.temporal_shift_kernel")
sgk = importlib.import_module("shift_gcn_tpu.ops.pallas.shift_gcn_kernel")

REDUCED = {"num_class": 5, "num_point": 33, "num_person": 2,
           "graph": "mediapipe_pose",
           "blocks": [[3, 8, 1, False], [8, 16, 2], [16, 16]]}
FULL = {"num_class": 2, "num_point": 33, "num_person": 1,
        "graph": "mediapipe_pose"}


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(tsk, "_INTERPRET", True)
    monkeypatch.setattr(sgk, "_INTERPRET", True)


def _arrays(cfg, seed):
    """Reference init, then non-trivial BN affine and running stats so
    every BN layout is exercised."""
    params, state = jax_model.init_params(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map(np.array, params)
    state = jax.tree_util.tree_map(np.array, state)
    rng = np.random.default_rng(seed)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k == "running_mean":
                tree[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
            elif k == "running_var":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "num_batches_tracked":
                tree[k] = np.asarray(7, np.int32)

    def perturb_bn_affine(tree):
        # BN parameter dicts are the {weight, bias} pairs with 1-D weights
        # (conv weights are 4-D, the classifier's 2-D)
        for v in tree.values():
            if not isinstance(v, dict):
                continue
            if set(v) == {"weight", "bias"} and v["weight"].ndim == 1:
                v["weight"] = rng.uniform(0.5, 1.5, v["weight"].shape
                                          ).astype(np.float32)
                v["bias"] = rng.normal(0, 0.2, v["bias"].shape
                                       ).astype(np.float32)
            else:
                perturb_bn_affine(v)

    perturb(state)
    perturb_bn_affine(params)
    return params, state


def _inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _port(cfg_args, params, state, **cfg_overrides):
    cfg = dataclasses.replace(config_from_reference_args(cfg_args),
                              **cfg_overrides)
    model = Model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_arrays(params, state), strict=True)
    return model


def test_state_dict_from_arrays_matches_reference_export():
    cfg = jax_model.config_from_reference_args(REDUCED)
    params, state = _arrays(cfg, 0)
    want = pytrees_to_torch_state_dict(params, state)
    got = state_dict_from_arrays(params, state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("args", [REDUCED, FULL])
def test_model_loads_reference_state_dict_strictly(args):
    cfg = jax_model.config_from_reference_args(args)
    params, state = _arrays(cfg, 1)
    model = _port(args, params, state)
    assert set(model.state_dict()) == set(
        pytrees_to_torch_state_dict(params, state))


def test_load_raises_on_shift_outside_tap_radius():
    cfg = jax_model.config_from_reference_args(REDUCED)
    params, state = _arrays(cfg, 2)
    params["l2"]["tcn1"]["shift_out"]["ypos"][3] = 7.6
    with pytest.raises(ValueError, match="l2.tcn1.shift_out.ypos"):
        _port(REDUCED, params, state)


def test_model_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(config_from_reference_args(REDUCED))


def test_reduced_model_matches_pallas_lowering(interpret):
    # reduced backbone: a down conv (3->8), a stride-2 unit with a
    # residual conv (8->16), an identity residual; 2 persons
    cfg = jax_model.config_from_reference_args(REDUCED)
    cfg = jax_model.ModelConfig(**{
        **cfg.__dict__, "use_pallas": True,
        "lowering": Lowering(tshift_impl="pallas")})
    params, state = _arrays(cfg, 3)
    x = _inputs((2, 3, 32, 33, 2), 3)
    want, _ = jax_model.apply(params, state, x, cfg, training=False)
    got = _port(REDUCED, params, state)(torch.from_numpy(x))
    # fp32: same ops, summation order differs (1e-5 relative to logits)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5 * max(scale, 1.0), rtol=1e-5)


def test_full_model_matches_default_lowering():
    # the 10-block backbone against the reference's default eval lowering
    # (frequency-domain temporal and spatial transforms): same function,
    # fp32 roundoff of a different algorithm through 10 units
    cfg = jax_model.config_from_reference_args(FULL)
    params, state = _arrays(cfg, 4)
    x = _inputs((1, 3, 16, 33, 1), 4)
    want, _ = jax_model.apply(params, state, x, cfg, training=False)
    got = _port(FULL, params, state)(torch.from_numpy(x))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4 * max(scale, 1.0), rtol=1e-4)


def test_bf16_activations_match_reference(interpret):
    # bf16 activations on both sides (params, BN stats, pooling, fc fp32);
    # bf16 keeps 8 bits, so 3 units of rounding leave ~1e-2 relative
    cfg = jax_model.config_from_reference_args(REDUCED)
    cfg = jax_model.ModelConfig(**{
        **cfg.__dict__, "use_pallas": True, "activation_dtype": "bfloat16",
        "lowering": Lowering(tshift_impl="pallas")})
    params, state = _arrays(cfg, 5)
    x = _inputs((2, 3, 32, 33, 2), 5)
    want, _ = jax_model.apply(params, state, x, cfg, training=False)
    got = _port(REDUCED, params, state, activation_dtype="bfloat16")(
        torch.from_numpy(x))
    assert got.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=3e-2 * max(scale, 1.0), rtol=3e-2)
