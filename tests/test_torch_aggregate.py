"""The port's graph aggregation ops (shift_gcn_torch.ops.aggregate) and
skeleton adjacency against the reference package on the CPU, on the same
seeded inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from shift_gcn_tpu.graphs import topology as jax_topology
from shift_gcn_tpu.ops import aggregate as jax_aggregate
from shift_gcn_torch.graphs import topology
from shift_gcn_torch.ops import aggregate

GRAPHS = ["ntu_rgb_d", "ntu120_rgb_d", "mediapipe_pose"]
# fp32 products summed in another order: 1e-5 of the output's scale
TOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert tuple(got.shape) == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("name", GRAPHS)
def test_adjacency_is_bit_equal(name):
    got, want = topology.get_graph(name), jax_topology.get_graph(name)
    assert got.A.dtype == want.A.dtype == np.float32
    np.testing.assert_array_equal(got.A, want.A)
    assert got.inward == want.inward and got.outward == want.outward
    assert got.neighbor == want.neighbor
    coo, want_coo = got.coo(), want.coo()
    assert list(coo) == list(want_coo)
    for key, value in want_coo.items():
        assert coo[key].dtype == value.dtype, key
        np.testing.assert_array_equal(coo[key], value, err_msg=key)
    edges = [(0, 1), (2, 1), (3, 3)]
    np.testing.assert_array_equal(topology.edge_matrix(edges, 4),
                                  jax_topology.edge_matrix(edges, 4))
    a = topology.edge_matrix(edges, 4)
    np.testing.assert_array_equal(topology.normalize_columns(a),
                                  jax_topology.normalize_columns(a))


def _edges(name):
    coo = topology.get_graph(name).coo()
    return ({k: torch.from_numpy(coo[k]) for k in ("src", "dst", "weight")},
            {k: jnp.asarray(coo[k]) for k in ("src", "dst", "weight")})


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("with_weight", [False, True])
def test_dense_graph_aggregate(name, with_weight):
    rng = np.random.default_rng(1)
    a = topology.get_graph(name).A
    v = a.shape[1]
    x = rng.standard_normal((2, 5, v, 6)).astype(np.float32)
    w = (rng.standard_normal((3, 6, 4)).astype(np.float32)
         if with_weight else None)
    want = jax_aggregate.dense_graph_aggregate(
        jnp.asarray(x), jnp.asarray(a), None if w is None else jnp.asarray(w))
    got = aggregate.dense_graph_aggregate(
        torch.from_numpy(x), torch.from_numpy(a),
        None if w is None else torch.from_numpy(w))
    _close(got, want)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("op", ["edge_aggregate", "edge_aggregate_onehot"])
def test_edge_aggregate(name, op):
    rng = np.random.default_rng(2)
    v = topology.get_graph(name).num_nodes
    x = rng.standard_normal((3, 4, v, 5)).astype(np.float32)
    edges, jax_edges = _edges(name)
    want = getattr(jax_aggregate, op)(jnp.asarray(x), jax_edges, v)
    got = getattr(aggregate, op)(torch.from_numpy(x), edges, v)
    _close(got, want)
    # both forms compute the same contraction
    _close(aggregate.edge_aggregate_onehot(torch.from_numpy(x), edges, v),
           jax_aggregate.edge_aggregate(jnp.asarray(x), jax_edges, v))


def test_edge_aggregate_repeated_edges_and_unbatched():
    # repeated (src, dst) pairs add up; a (V, C) input has no batch axes
    rng = np.random.default_rng(3)
    v = 7
    src = np.array([0, 0, 3, 6, 6, 2], np.int32)
    dst = np.array([1, 1, 3, 0, 5, 2], np.int32)
    weight = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    x = rng.standard_normal((v, 3)).astype(np.float32)
    edges = {"src": torch.from_numpy(src), "dst": torch.from_numpy(dst),
             "weight": torch.from_numpy(weight)}
    jax_edges = {"src": jnp.asarray(src), "dst": jnp.asarray(dst),
                 "weight": jnp.asarray(weight)}
    for op in ("edge_aggregate", "edge_aggregate_onehot"):
        _close(getattr(aggregate, op)(torch.from_numpy(x), edges, v),
               getattr(jax_aggregate, op)(jnp.asarray(x), jax_edges, v))


@pytest.mark.parametrize("name", GRAPHS)
def test_sddmm(name):
    rng = np.random.default_rng(4)
    graph = topology.get_graph(name)
    v = graph.num_nodes
    a = rng.standard_normal((2, 3, v, 8)).astype(np.float32)
    b = rng.standard_normal((2, 3, v, 8)).astype(np.float32)
    edges, jax_edges = _edges(name)
    _close(aggregate.sddmm(torch.from_numpy(a), torch.from_numpy(b), edges),
           jax_aggregate.sddmm(jnp.asarray(a), jnp.asarray(b), jax_edges))
    mask = (graph.A.sum(0) > 0).astype(np.float32)
    _close(aggregate.sddmm_dense(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(mask)),
           jax_aggregate.sddmm_dense(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(mask)))
