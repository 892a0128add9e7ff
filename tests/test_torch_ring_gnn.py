"""The port's ring-GNN family (shift_gcn_torch.models.ring_gnn) against the
reference package on the CPU: the synthetic graph bit for bit, the
forward, the gradients and one SGD step on the same weights, the data
contract, and the Trainer end to end from ``configs/synthetic_ring.yaml``
without its mesh keys."""

import os
import pickle

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from shift_gcn_tpu.models import ring_gnn as jax_ring
from shift_gcn_tpu.train import state as jax_state
from shift_gcn_tpu.train.optim import (
    build_weight_decay_tree, init_sgd, sgd_update)
from shift_gcn_torch.cli import train as cli_train
from shift_gcn_torch.models import ring_gnn
from shift_gcn_torch.train import optim, state
from shift_gcn_torch.train.config import load_config
from shift_gcn_torch.train.trainer import Trainer
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "synthetic_ring.yaml")
SMALL = {"num_class": 3, "num_nodes": 40, "in_channels": 5,
         "hidden": [6, 7, 4], "graph_seed": 11, "extra_edges": 90}
# fp32 products and segment sums in another order: 1e-5 of scale
TOL = 1e-5


@pytest.mark.parametrize("args", [{}, SMALL,
                                  {"num_nodes": 17, "extra_edges": 0}])
def test_synthetic_graph_is_bit_equal(args):
    got = ring_gnn.synthetic_graph(ring_gnn.config_from_args(args))
    want = jax_ring.synthetic_graph(jax_ring.config_from_args(args))
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert ring_gnn.config_from_args(args).__dict__ == \
        jax_ring.config_from_args(args).__dict__


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_arrays(tree, {}).items()}


@pytest.mark.parametrize("args", [{}, SMALL], ids=["default", "small"])
def test_forward_grads_and_step_match_reference(args):
    cfg = jax_ring.config_from_args(args)
    params, _ = jax_ring.init_params(jax.random.key(5), cfg)
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(5)
    for layer in params.values():
        layer["bias"] = rng.normal(0, 0.1, layer["bias"].shape
                                   ).astype(np.float32)
    x = rng.standard_normal((4, cfg.in_channels, 1, cfg.num_nodes, 1)
                            ).astype(np.float32)
    labels = rng.integers(0, cfg.num_class, 4).astype(np.int32)

    model = ring_gnn.Model(ring_gnn.config_from_args(args), device="cpu")
    model.load_state_dict(state_dict_from_arrays(params, {}), strict=True)
    assert set(model.state_dict()) == set(_flat(params))

    def loss_fn(p):
        logits, _ = jax_ring.apply(p, {}, x, cfg, training=True)
        return jax_state.cross_entropy(logits, labels), logits

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    (loss, logits), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    new_params, _ = sgd_update(jparams, grads, init_sgd(jparams),
                               jnp.float32(0.05),
                               build_weight_decay_tree(jparams))

    with torch.no_grad():
        got_logits = model(torch.from_numpy(x)).numpy()
    scale = max(1.0, float(np.abs(np.asarray(logits)).max()))
    np.testing.assert_allclose(got_logits, np.asarray(logits), rtol=0,
                               atol=TOL * scale)
    opt = optim.build_optimizer(model, 0.05)
    got_loss, _ = state.train_step(
        model, opt, {"data": torch.from_numpy(x),
                     "label": torch.from_numpy(labels).long()}, 0.05)
    assert abs(float(got_loss) - float(loss)) <= TOL * max(1.0,
                                                           float(loss))
    want_g = _flat(jax.tree_util.tree_map(np.asarray, grads))
    got_g = {n: p.grad.numpy() for n, p in model.named_parameters()}
    for name, w in want_g.items():
        np.testing.assert_allclose(
            got_g[name], w, rtol=0,
            atol=TOL * max(1.0, float(np.abs(w).max())), err_msg=name)
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    for name, w in _flat(jax.tree_util.tree_map(np.asarray,
                                                new_params)).items():
        np.testing.assert_allclose(sd[name], w, rtol=0, atol=1e-6,
                                   err_msg=name)


def test_init_and_data_contract():
    model = ring_gnn.Model(ring_gnn.config_from_args(SMALL), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    want = _flat(jax.tree_util.tree_map(np.asarray, jax_ring.init_params(
        jax.random.key(0), jax_ring.config_from_args(SMALL))[0]))
    assert {k: tuple(t.shape) for k, t in model.state_dict().items()} == {
        k: w.shape for k, w in want.items()}
    assert not model.l1.bias.any()
    # clips are (N, C, 1, V, 1): the reference's data contract
    for shape in ((2, 5, 2, 40, 1), (2, 5, 1, 40, 2), (2, 5, 1, 39, 1)):
        with pytest.raises(ValueError, match="ring-GNN clips"):
            model(torch.zeros(shape))


def _ring_data(root, n, seed, num_nodes=256, channels=8):
    """A separable two-class node-feature set: the class shifts the mean of
    every node's first channel."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    data = rng.standard_normal((n, channels, 1, num_nodes, 1)).astype(
        np.float32)
    data[:, 0] += (labels * 1.5 - 0.75)[:, None, None, None]
    paths = {"data_path": os.path.join(root, f"d{seed}.npy"),
             "label_path": os.path.join(root, f"l{seed}.pkl")}
    np.save(paths["data_path"], data)
    with open(paths["label_path"], "wb") as f:
        pickle.dump(([f"s{i}" for i in range(n)], labels.tolist()), f)
    return paths


def test_trainer_trains_synthetic_ring_yaml_without_mesh_keys(tmp_path):
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    for key in ("mesh_shape", "edge_partition", "edge_strategy"):
        cfg.pop(key)
    cfg.update(work_dir=str(tmp_path / "work"),
               model_saved_name=str(tmp_path / "save"),
               train_feeder_args=_ring_data(str(tmp_path), 48, 0),
               test_feeder_args=_ring_data(str(tmp_path), 16, 1))
    path = tmp_path / "ring.yaml"
    path.write_text(yaml.safe_dump(cfg))
    best = cli_train.main(["--config", str(path), "--num_epoch", "3",
                           "--torch-device", "cpu"])
    save_dir = tmp_path / "save" / "synthetic_ring"
    eval_dir = tmp_path / "work" / "synthetic_ring" / "eval_results"
    assert sorted(os.listdir(save_dir)) == [
        f"synthetic_ring-{e}-{3 * (e + 1)}.pt" for e in range(3)]
    assert (eval_dir / "best_acc.pkl").exists()
    assert best >= 0.75  # separable set, lr 0.05
    scores = pickle.load(open(eval_dir / "best_acc.pkl", "rb"))
    assert len(scores) == 16 and next(iter(scores.values())).shape == (2,)
    # the snapshot records no lowering: the family has none
    snapshot = yaml.safe_load(open(tmp_path / "work" / "synthetic_ring"
                                   / "config.yaml"))
    assert snapshot["lowering"] == {}
    # resume continues from the last checkpoint
    trainer = Trainer(load_config(["--config", str(path), "--num_epoch",
                                   "4", "--resume", "auto"]), device="cpu")
    assert (trainer.start_epoch, trainer.global_step) == (3, 9)
    assert isinstance(trainer.model, ring_gnn.Model)
