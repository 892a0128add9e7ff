"""The port's edge partition (``parallel/edge_partition.py``) against the
reference package's ``parallel/edge_partition.py`` on the CPU:

- the bookkeeping (``partition_edges``, ``partition_edges_ring``,
  ``subset_coo_from_adjacency``) bit-equal, padding and per-step bucket
  widths included;
- in 4 gloo processes (tests/torch_parallel_ranks.py, job ``edge``,
  spawned once for the file), against the reference on a mesh of its
  virtual CPU devices: each standalone aggregator (``gather``, ``ring``)
  against ``make_sharded_aggregator`` within 1e-5 of scale, with the
  adjoints (the gather's all-reduce sums the ranks' cotangents; the
  ring's backward carries each cotangent block back around the ring);
- one fp32 train step and an eval step from the same weights (carried
  across by ``state_dict_from_arrays``) and batch: ST-GCN under
  ``gather`` at [2, 2] and [1, 4], the ring-GNN under ``ring`` at
  [1, 4] (32 nodes), against ``make_edge_sharded_train_step`` /
  ``make_edge_sharded_eval_step`` on the same mesh and against the
  port's one-process step: ST-GCN's loss within 1e-6 relative and its
  gradients within tests/test_torch_stgcn.py's tolerances (behind a
  train-mode BN fp32 sums cancel); the ring-GNN's (no BN) within 1e-5
  of scale;
- the reference trainer's refusals of ``edge_partition``
  (tests/test_edge_training.py, tests/test_ring_training.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shift_gcn_tpu.graphs import get_graph as jax_get_graph
from shift_gcn_tpu.models import ring_gnn as jax_ring
from shift_gcn_tpu.models import stgcn as jax_stgcn
from shift_gcn_tpu.models.registry import get_model as jax_get_model
from shift_gcn_tpu.parallel import edge_partition as jax_ep
from shift_gcn_tpu.train import state as jax_state
from shift_gcn_tpu.train.optim import build_weight_decay_tree, init_sgd
from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.parallel import edge_partition
from shift_gcn_torch.parallel.mesh import Mesh
from shift_gcn_torch.train import config
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays
from torch_parallel_helpers import jax_mesh
from torch_parallel_ranks import run_ranks

STGCN_ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
              "graph": "mediapipe_pose", "channels": [8, 16],
              "strides": [1, 2]}
RING_ARGS = {"num_class": 2, "num_nodes": 32, "in_channels": 4,
             "hidden": [8, 8], "graph_seed": 5, "extra_edges": 64}
LR = 0.1
# biases that feed a train-mode BN (exact gradient 0), and the weight
# whose gradient scale holds their roundoff (tests/test_torch_stgcn.py)
ZERO_GRAD_BIASES = (("gcn_bias", "gcn_weight"), ("tcn.bias", "tcn.weight"),
                    ("down.bias", "down.weight"))
RING_TOL = 1e-5  # of scale: no BN, another fp32 order


def _random_edges(rng, v, e):
    return {"src": rng.integers(0, v, e).astype(np.int32),
            "dst": rng.integers(0, v, e).astype(np.int32),
            "weight": rng.uniform(0.5, 1.5, e).astype(np.float32)}


def _assert_same_arrays(got, want):
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.mark.parametrize("e,p", [(40, 4), (41, 4), (7, 8), (64, 2)])
def test_partition_edges_is_bit_equal(e, p):
    edges = _random_edges(np.random.default_rng(e), 13, e)
    _assert_same_arrays(edge_partition.partition_edges(edges, p),
                        jax_ep.partition_edges(edges, p))


@pytest.mark.parametrize("v,p,extra", [(32, 4, 64), (13, 4, 0),
                                       (256, 8, 512), (30, 2, 5)])
def test_partition_edges_ring_is_bit_equal(v, p, extra):
    edges = jax_ring.synthetic_graph(jax_ring.RingGNNConfig(
        num_nodes=v, extra_edges=extra))
    steps, v_pad, v_loc = edge_partition.partition_edges_ring(edges, p, v)
    want, w_pad, w_loc = jax_ep.partition_edges_ring(edges, p, v)
    assert (v_pad, v_loc) == (w_pad, w_loc)
    assert [s["weight"].shape for s in steps] == [
        s["weight"].shape for s in want]
    for got, ref in zip(steps, want):
        _assert_same_arrays(got, ref)


@pytest.mark.parametrize("graph", ["mediapipe_pose", "ntu_rgb_d"])
def test_subset_coo_from_adjacency_is_bit_equal(graph):
    a = get_graph(graph).A
    np.testing.assert_array_equal(a, jax_get_graph(graph).A)
    _assert_same_arrays(edge_partition.subset_coo_from_adjacency(a),
                        jax_ep.subset_coo_from_adjacency(a))


def _stgcn_inputs(seed):
    """Reference init with non-trivial BN statistics and a non-zero B,
    and a batch of 4 clips with both classes."""
    cfg = jax_get_model("stgcn").build_config(STGCN_ARGS)
    params, bn_state = jax.tree_util.tree_map(
        np.array, jax_stgcn.init_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "running_mean":
                tree[k] = rng.normal(0, 0.3, v.shape).astype(np.float32)
            elif k == "running_var":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "B":
                tree[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)

    walk(params)
    walk(bn_state)
    return {"args": STGCN_ARGS, "lr": LR, "params": params,
            "bn_state": bn_state,
            "data": rng.standard_normal((4, 3, 16, 33, 1)).astype(
                np.float32),
            "label": np.asarray([0, 1, 1, 0], np.int32),
            "mask": np.asarray([1, 1, 1, 0], np.float32)}


def _ring_inputs(seed):
    cfg = jax_ring.config_from_args(RING_ARGS)
    params, _ = jax_ring.init_params(jax.random.key(seed), cfg)
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(seed)
    for layer in params.values():
        layer["bias"] = rng.normal(0, 0.1, layer["bias"].shape).astype(
            np.float32)
    return {"args": RING_ARGS, "lr": LR, "params": params,
            "data": rng.standard_normal((4, 4, 1, 32, 1)).astype(
                np.float32),
            "label": np.asarray([1, 0, 0, 1], np.int32),
            "mask": np.asarray([1, 1, 0, 1], np.float32)}


def _agg_inputs():
    rng = np.random.default_rng(9)
    return {"edges": _random_edges(rng, 13, 40), "v": 13,
            "x": rng.standard_normal((2, 13, 3)).astype(np.float32),
            "cot": rng.standard_normal((4, 2, 13, 3)).astype(np.float32)}


@pytest.fixture(scope="module")
def edge_run(tmp_path_factory):
    inputs = {"agg": _agg_inputs(), "stgcn": _stgcn_inputs(2),
              "ring": _ring_inputs(3)}
    return inputs, run_ranks("edge", tmp_path_factory.mktemp("edge"), 4,
                             inputs)


def _scale(a):
    return max(1.0, float(np.abs(a).max()))


def test_aggregators_and_adjoints_match_reference(edge_run):
    inputs, outs = edge_run
    c = inputs["agg"]
    mesh = jax_mesh((1, 4))
    x, total = jnp.asarray(c["x"]), jnp.asarray(c["cot"].sum(0))
    for strategy in ("gather", "ring"):
        agg = jax_ep.make_sharded_aggregator(c["edges"], c["v"], mesh,
                                             strategy=strategy)
        want, vjp = jax.vjp(agg, x)
        want, (dx,) = np.asarray(want), vjp(total)
        for out in outs:
            np.testing.assert_allclose(out["agg"][strategy], want, rtol=0,
                                       atol=1e-5 * _scale(want))
        if strategy == "gather":
            # each rank's x gradient: its edges' adjoint of the summed
            # cotangent; the ranks' parts add up to the reference's
            parts = edge_partition.partition_edges(c["edges"], 4)
            for m, out in enumerate(outs):
                mine = {k: v[m] for k, v in parts.items()}
                part = np.zeros_like(c["x"])
                np.add.at(part, (slice(None), mine["src"]),
                          mine["weight"][:, None]
                          * c["cot"].sum(0)[:, mine["dst"]])
                np.testing.assert_allclose(out["agg"]["gather_dx"], part,
                                           rtol=0, atol=1e-5)
            got = sum(out["agg"]["gather_dx"] for out in outs)
        else:
            # the ring's blocks: this rank's aggregate and the adjoint of
            # its block (V padded to 16, 4 nodes a rank)
            got = np.concatenate([o["agg"]["ring_dx"] for o in outs],
                                 1)[:, :c["v"]]
            np.testing.assert_allclose(
                np.concatenate([o["agg"]["ring_block"] for o in outs],
                               1)[:, :c["v"]], want, rtol=0,
                atol=1e-5 * _scale(want))
        np.testing.assert_allclose(got, np.asarray(dx), rtol=0,
                                   atol=1e-5 * _scale(dx))


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_arrays(tree, {}).items()}


def _jax_edge(c, shape, family):
    """The reference's gradients, stepped state, metrics and eval outputs
    of ``family`` edge-partitioned over a ``shape`` mesh."""
    cfg = jax_get_model(family).build_config(c["args"])
    mesh = jax_mesh(shape)
    if family == "stgcn":
        apply = jax_ep.make_edge_sharded_apply(cfg, mesh)
        bn_state = c["bn_state"]
    else:
        apply = jax_ep.make_ring_sharded_apply(cfg, mesh,
                                               apply_fn=jax_ring.apply)
        bn_state = {}
    params = jax.tree_util.tree_map(jnp.asarray, c["params"])
    bn_state = jax.tree_util.tree_map(jnp.asarray, bn_state)
    data, label = jnp.asarray(c["data"]), jnp.asarray(c["label"])

    def loss_fn(p):
        logits, _ = apply(p, bn_state, data, True)
        return jax_state.cross_entropy(logits, label)

    grads = _flat(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.grad(loss_fn))(params)))
    state = jax_state.TrainState(params=params, bn_state=bn_state,
                                 opt_state=init_sgd(params),
                                 global_step=jnp.zeros((), jnp.int32))
    step = jax_ep.make_edge_sharded_train_step(
        cfg, build_weight_decay_tree(params), mesh, sharded_apply=apply)
    new_state, metrics = jax.jit(step)(
        state, {"data": data, "label": label}, jnp.float32(c["lr"]))
    evaluate = jax_ep.make_edge_sharded_eval_step(cfg, mesh,
                                                  sharded_apply=apply)
    evaluated = jax.jit(evaluate)(params, bn_state, {
        "data": data, "label": label, "mask": jnp.asarray(c["mask"])})
    return grads, new_state, metrics, evaluated


def _grad_tols(grads, family):
    """Per-parameter absolute tolerances: ST-GCN's as
    tests/test_torch_stgcn.py holds them, the ring-GNN's 1e-5 of scale."""
    tol = {}
    for name, want in grads.items():
        if family == "ring":
            tol[name] = RING_TOL * _scale(want)
            continue
        weight = next((name[:-len(b)] + w for b, w in ZERO_GRAD_BIASES
                       if name.endswith(b)), None)
        tol[name] = (5e-4 * float(np.abs(grads[weight]).max()) if weight
                     else 1e-5 + 2e-4 * float(np.abs(want).max()))
    return tol


def _assert_step(got, want_loss, grads, new_params, stats, family, label):
    loss_tol = 1e-6 if family == "stgcn" else RING_TOL
    assert abs(got["loss"] - want_loss) <= loss_tol * max(
        1.0, abs(want_loss)), label
    assert set(got["grads"]) == set(grads), label
    tol = _grad_tols(grads, family)
    for name, want in grads.items():
        np.testing.assert_allclose(got["grads"][name], want, rtol=0,
                                   atol=tol[name], err_msg=f"{label} {name}")
    # after SGD: the gradients' gap times lr * (1 + momentum), plus fp32
    # roundoff
    for name, want in new_params.items():
        np.testing.assert_allclose(got["state"][name], want, rtol=0,
                                   atol=1e-6 + 0.19 * tol[name],
                                   err_msg=f"{label} {name}")
    for name, want in stats.items():
        np.testing.assert_allclose(got["state"][name], want, rtol=1e-5,
                                   atol=1e-6, err_msg=f"{label} {name}")


@pytest.mark.parametrize("case,shape,family", [
    ("stgcn22", (2, 2), "stgcn"), ("stgcn14", (1, 4), "stgcn"),
    ("ring14", (1, 4), "ring")], ids=["gather-2x2", "gather-1x4",
                                      "ring-1x4"])
def test_steps_match_reference_and_one_process(edge_run, case, shape,
                                               family):
    inputs, outs = edge_run
    c = inputs["stgcn" if family == "stgcn" else "ring"]
    grads, new_state, metrics, (logits, loss_sum, n) = _jax_edge(
        c, shape, "stgcn" if family == "stgcn" else "ring_gnn")
    new_params = _flat(jax.tree_util.tree_map(np.asarray, new_state.params))
    stats = {k: v.numpy() for k, v in state_dict_from_arrays(
        {}, jax.tree_util.tree_map(np.asarray, new_state.bn_state)).items()}
    single = outs[0]["single"][family]
    for rank, out in enumerate(outs):
        got = out[case]
        _assert_step(got, float(metrics["loss"]), grads, new_params, stats,
                     family, f"{case} rank {rank} vs reference")
        # the port's one-process step, held to the same tolerances
        _assert_step(got, single["loss"], single["grads"], {
            k: v for k, v in single["state"].items() if k in new_params},
            {k: v for k, v in single["state"].items() if k in stats},
            family, f"{case} rank {rank} vs one process")
        np.testing.assert_allclose(got["logits"], np.asarray(logits), rtol=0,
                                   atol=1e-5 * _scale(logits))
        assert abs(got["loss_sum"] - float(loss_sum)) <= 1e-5 * max(
            1.0, abs(float(loss_sum)))
        assert got["n"] == float(n) == 3.0
    # every rank holds the same replicated parameters after the step
    for out in outs[1:]:
        for name, value in outs[0][case]["state"].items():
            np.testing.assert_array_equal(out[case]["state"][name], value)


BASE = {"model": "stgcn", "mesh_shape": [1, 4], "edge_partition": True}


@pytest.mark.parametrize("overrides,match", [
    ({"fourstream": True}, "edge_partition.*fourstream"),
    ({"shard_time": True}, "composition"),
    ({"mesh_shape": [8, 1]}, "model >= 2"),
    ({"mesh_shape": None}, "model >= 2"),
    ({"edge_strategy": "ring"}, "ring_gnn"),
    ({"model": "shift_gcn"}, "edges"),
    ({"model": "shift_gcn_tpu.models.ring_gnn"}, "stgcn family has"),
    ({"edge_strategy": "scatter"}, "unknown edge_strategy")],
    ids=["fourstream", "shard_time", "model-axis-1", "no-mesh",
         "ring-stgcn", "gather-shift_gcn", "gather-ring_gnn", "unknown"])
def test_refusals_match_reference_trainer(overrides, match):
    with pytest.raises(ValueError, match=match):
        config.check_supported(dataclasses.replace(
            config.ExperimentConfig(**BASE), **overrides))


def test_edge_layouts_are_taken_and_not_tensor_parallel():
    # under the edge partition the model axis carries edges: no width of
    # the model needs to split over it
    for overrides in ({"mesh_shape": [2, 3]}, {
            "model": "shift_gcn_tpu.models.ring_gnn",
            "edge_strategy": "ring", "mesh_shape": [1, 8]}):
        config.check_supported(dataclasses.replace(
            config.ExperimentConfig(**BASE), **overrides))


def test_sharded_aggregator_needs_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    edges = get_graph("mediapipe_pose").coo()
    mesh = Mesh(1, 2)
    for strategy in ("gather", "ring"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            edge_partition.make_sharded_aggregator(edges, 33, mesh, strategy)
        assert callable(edge_partition.make_sharded_aggregator(
            edges, 33, mesh, strategy, device="cpu"))
