"""The port's ST-GCN family (shift_gcn_torch.models.stgcn) against the
reference package's ``stgcn.apply`` on the CPU: a reduced model with the
learnable residual adjacency B on and off and the attention embedding
width 0 and 4, on the MediaPipe graph (M=1) and on NTU (M=2), with the
same weights carried over by ``state_dict_from_arrays``: the eval
forward, the train-mode forward and its BN running statistics, and one
SGD step against the reference optimizer."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shift_gcn_tpu.models import stgcn as jax_stgcn
from shift_gcn_tpu.models.registry import get_model as jax_get_model
from shift_gcn_tpu.train import state as jax_state
from shift_gcn_tpu.train.optim import (
    build_weight_decay_tree, init_sgd, sgd_update, weight_decay_for_path)
from shift_gcn_torch.models import stgcn
from shift_gcn_torch.train import optim, state
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

GRAPHS = {
    "mediapipe": {"num_class": 3, "num_point": 33, "num_person": 1,
                  "graph": "mediapipe_pose"},
    "ntu": {"num_class": 4, "num_point": 25, "num_person": 2,
            "graph": "ntu_rgb_d"},
}
# three blocks: a width change with a down conv (3->8), a stride-2 block
# with a down conv (8->16), an identity residual
REDUCED = {"channels": [8, 16, 16], "strides": [1, 2, 1]}
LR = 0.1
# biases that feed a train-mode BN normalizing over their broadcast axes
# (gcn_bias -> bn1, tcn.bias -> bn2, down.bias -> down_bn): the mean
# subtraction cancels them, so their exact gradient is 0 and each side
# computes roundoff; (bias suffix, the weight whose gradient scales it)
ZERO_GRAD_BIASES = (("gcn_bias", "gcn_weight"), ("tcn.bias", "tcn.weight"),
                    ("down.bias", "down.weight"))


@pytest.fixture(scope="module", autouse=True)
def no_onednn():
    # torch's oneDNN convolution backward corrupts the heap on the CPU once
    # the reference package's compiled XLA code has run in the same process
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = saved


def _args(graph, adaptive, embed):
    return dict(GRAPHS[graph], **REDUCED, adaptive=adaptive,
                adaptive_embed=embed)


def _arrays(cfg, seed):
    """Reference init, then non-trivial BN statistics and affine, and a
    non-zero B, so every term is exercised."""
    params, bn_state = jax_stgcn.init_params(jax.random.key(seed), cfg)
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
            elif k == "num_batches_tracked":
                tree[k] = np.asarray(5, np.int32)
            elif k == "B":
                tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)

    walk(params)
    walk(bn_state)
    return params, bn_state


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_arrays(tree, {}).items()}


CASES = [(g, a, e) for g in GRAPHS for a in (True, False) for e in (0, 4)]


@pytest.mark.parametrize("graph,adaptive,embed", CASES,
                         ids=[f"{g}-B{int(a)}-embed{e}" for g, a, e in CASES])
def test_forward_and_step_match_reference(graph, adaptive, embed):
    args = _args(graph, adaptive, embed)
    cfg = jax_get_model("stgcn").build_config(args)
    port_cfg = stgcn.config_from_args(args)
    assert port_cfg.__dict__ == cfg.__dict__
    seed = CASES.index((graph, adaptive, embed))
    params, bn_state = _arrays(cfg, seed)
    rng = np.random.default_rng(100 + seed)
    m, v = args["num_person"], args["num_point"]
    x = rng.standard_normal((3, 3, 20, v, m)).astype(np.float32)
    labels = rng.integers(0, args["num_class"], 3).astype(np.int32)

    model = stgcn.Model(port_cfg, device="cpu")
    model.load_state_dict(state_dict_from_arrays(params, bn_state),
                          strict=True)
    assert hasattr(model.l1, "B") == adaptive
    assert hasattr(model.l1, "theta") == bool(embed)

    # eval forward: fp32, other summation orders, 1e-5 of scale
    want_eval, _ = jax_stgcn.apply(params, bn_state, x, cfg, training=False)
    with torch.no_grad():
        got_eval = model(torch.from_numpy(x)).numpy()
    scale = max(1.0, float(np.abs(want_eval).max()))
    np.testing.assert_allclose(got_eval, np.asarray(want_eval), rtol=0,
                               atol=1e-5 * scale)

    # one train step: the reference's gradient and SGD update
    def loss_fn(p):
        logits, new_bn = jax_stgcn.apply(p, bn_state, x, cfg, training=True)
        return jax_state.cross_entropy(logits, labels), (logits, new_bn)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    (loss, (logits, new_bn)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    new_params, _ = sgd_update(jparams, grads, init_sgd(jparams),
                               jnp.float32(LR),
                               build_weight_decay_tree(jparams))
    opt = optim.build_optimizer(model, LR)
    got_loss, _ = state.train_step(
        model, opt, {"data": torch.from_numpy(x),
                     "label": torch.from_numpy(labels).long()}, LR)
    assert abs(float(got_loss) - float(loss)) <= 1e-5 * max(
        1.0, abs(float(loss)))
    # true gradients: fp32 roundoff of another summation order through
    # three train-mode BNs, the one-step envelope of tests/test_torch_train
    want_g = _flat(jax.tree_util.tree_map(np.asarray, grads))
    got_g = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got_g) == set(want_g)
    grad_tol = {}
    for name, w in want_g.items():
        weight = next((name[:-len(b)] + wn for b, wn in ZERO_GRAD_BIASES
                       if name.endswith(b)), None)
        if weight is not None:
            # exact gradient 0: each side's roundoff, held at 5e-4 of the
            # scale of its layer's weight gradient (measured <= 1.5e-4)
            grad_tol[name] = 5e-4 * float(np.abs(want_g[weight]).max())
            assert float(np.abs(w).max()) <= grad_tol[name], name
            assert float(np.abs(got_g[name]).max()) <= grad_tol[name], name
            continue
        grad_tol[name] = 1e-5 + 2e-4 * float(np.abs(w).max())
        np.testing.assert_allclose(got_g[name], w, rtol=0,
                                   atol=grad_tol[name], err_msg=name)
    # after SGD: the gradients' gap times lr * (1 + momentum), plus fp32
    # roundoff
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    for name, w in _flat(jax.tree_util.tree_map(np.asarray,
                                                new_params)).items():
        np.testing.assert_allclose(sd[name], w, rtol=0,
                                   atol=1e-6 + 0.19 * grad_tol[name],
                                   err_msg=name)
    # the train-mode BN state: batch statistics folded in with momentum
    stats = state_dict_from_arrays({}, jax.tree_util.tree_map(np.asarray,
                                                              new_bn))
    assert set(stats) == {k for k in sd if "running_" in k
                          or "num_batches" in k}
    for name, w in stats.items():
        np.testing.assert_allclose(sd[name], w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_init_names_shapes_and_scales_match_reference(graph):
    args = _args(graph, True, 4)
    cfg = jax_get_model("stgcn").build_config(args)
    want = state_dict_from_arrays(*jax.tree_util.tree_map(
        np.asarray, jax_stgcn.init_params(jax.random.key(0), cfg)))
    model = stgcn.Model(stgcn.config_from_args(args), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    got = model.state_dict()
    assert list(got) == sorted(got, key=list(got).index)
    assert {k: tuple(t.shape) for k, t in got.items()} == {
        k: tuple(t.shape) for k, t in want.items()}
    again = stgcn.Model(stgcn.config_from_args(args), device="cpu")
    again.init_weights(torch.Generator().manual_seed(0))
    for name, t in got.items():
        assert torch.equal(t, again.state_dict()[name]), name
        ref = want[name].float()
        if not ref.abs().any() or name.endswith(("running_var", "bn1.weight",
                                                  "bn2.weight")):
            # zeros and BN identities are drawn exactly
            assert torch.equal(t.float(), ref), name
    # normal draws at the reference's scales
    k_sub, cout = 3, args["channels"][0]
    std = float(got["l1.gcn_weight"].std())
    assert 0.5 < std / np.sqrt(2.0 / (k_sub * cout)) < 1.5
    assert not got["l1.B"].any()
    assert float(got["l1.theta"].std()) > 0


def test_weight_decay_table_matches_reference():
    model = stgcn.Model(stgcn.config_from_args(_args("ntu", True, 4)),
                        device="cpu")
    for name, _ in model.named_parameters():
        assert optim.weight_decay_for_name(name) == weight_decay_for_path(
            tuple(name.split("."))), name


def test_adaptive_attention_matches_reference():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 25, 5)).astype(np.float32)
    theta = rng.standard_normal((3, 5, 4)).astype(np.float32)
    phi = rng.standard_normal((3, 5, 4)).astype(np.float32)
    want = np.asarray(jax_stgcn.adaptive_attention(
        jnp.asarray(x), jnp.asarray(theta), jnp.asarray(phi)))
    got = stgcn.adaptive_attention(torch.from_numpy(x),
                                   torch.from_numpy(theta),
                                   torch.from_numpy(phi))
    assert got.shape == (3, 2, 25, 25)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=0, atol=1e-6)
