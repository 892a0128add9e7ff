"""Custom skeleton topologies (``register_graph``) and joint counts past
144 on the CPU, against the reference package.

The same seeded tree of V joints is registered in both packages: its
adjacency stack, bone parents, COO form and name lookup are bit-equal;
the registered name resolves through every consumer of a graph name in
the port (the Shift-GCN and ST-GCN configs, the Trainer and its
four-stream bone streams, the modality CLI, whose bone file matches the
reference's byte for byte, and the pipeline); and a narrow Shift-GCN at
V = 145, 160 and 289 (past the 144-row frame tile of the CUDA kernels K4
and K5) runs a forward and one fp32 train step against the reference
``apply`` with its default lowering and with its fused Shift-GCN
Pallas kernel in interpret mode, from the same weights
(``state_dict_from_arrays``): the train-mode logits, the loss and every
gradient.
Tolerances, the North star's: the forward at fp32 roundoff (1e-5 of the
logits' scale), true gradients at roundoff (1e-5 + 2e-4 of each
gradient's scale, ``test_torch_train.py``'s), the constraint position
steps bit-equal."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from shift_gcn_tpu.data.gendata import modality_cli as jax_modality_cli
from shift_gcn_tpu.graphs import topology as jax_topology
from shift_gcn_tpu.models import shift_gcn as jax_model
from shift_gcn_tpu.train import state as jax_state
from shift_gcn_torch import graphs
from shift_gcn_torch.cli import train as cli_train
from shift_gcn_torch.data.gendata import modality_cli
from shift_gcn_torch.graphs import topology
from shift_gcn_torch.inference.pipeline import EnsemblePredictor
from shift_gcn_torch.models import stgcn
from shift_gcn_torch.models.shift_gcn import Model, config_from_reference_args
from shift_gcn_torch.train import config, state
from shift_gcn_torch.train.trainer import Trainer
from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays
from test_torch_train import (  # noqa: F401 (fixtures)
    REPO, _assert_grads, _flat, interpret, no_onednn)

JOINTS = (145, 160, 289)
# 2 narrow units: a down conv without residual, a stride-2 unit with a
# residual conv
BLOCKS = [[3, 8, 1, False], [8, 16, 2]]
T = 16


def _tree(v: int) -> dict:
    """A seeded tree over v joints rooted at 0, as SkeletonGraph
    keywords: joint i > 0 hangs from a random earlier joint."""
    rng = np.random.default_rng(v)
    parents = [0] + [int(rng.integers(0, i)) for i in range(1, v)]
    edges = tuple((i, parents[i]) for i in range(1, v))
    return dict(name=f"tree{v}", num_nodes=v, inward=edges,
                bone_pairs=((0, 0),) + edges, center_joint=(0,),
                zaxis=(0, 1), xaxis=(1, 2))


@pytest.fixture(scope="module", autouse=True)
def trees():
    """Each tree registered in both packages for the module's tests."""
    for v in JOINTS:
        kw = _tree(v)
        graphs.register_graph(topology.SkeletonGraph(**kw))
        jax_topology.register_graph(jax_topology.SkeletonGraph(**kw))
    yield
    for v in JOINTS:
        del topology._REGISTRY[f"tree{v}"]
        del jax_topology._REGISTRY[f"tree{v}"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # these widths gain nothing from torch's intra-op pool while other
    # test workers hold the host's cores
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("v", JOINTS)
def test_registered_graph_matches_reference(v):
    name = f"tree{v}"
    got, want = graphs.get_graph(name), jax_topology.get_graph(name)
    assert got.num_nodes == want.num_nodes == v
    assert got.A.dtype == want.A.dtype == np.float32
    np.testing.assert_array_equal(got.A, want.A)
    np.testing.assert_array_equal(got.bone_parents(), want.bone_parents())
    got_coo, want_coo = got.coo(), want.coo()
    assert list(got_coo) == list(want_coo)
    for key, array in want_coo.items():
        assert got_coo[key].dtype == array.dtype, key
        np.testing.assert_array_equal(got_coo[key], array, err_msg=key)
    # the exported helpers build the same stack from the inward edges
    np.testing.assert_array_equal(
        graphs.spatial_adjacency(v, got.inward),
        jax_topology.spatial_adjacency(v, want.inward))
    np.testing.assert_array_equal(
        graphs.normalize_columns(graphs.edge_matrix(got.inward, v)),
        jax_topology.normalize_columns(jax_topology.edge_matrix(
            want.inward, v)))
    # the name lookup: the built-in aliases still resolve, an unknown
    # name raises in both, and a name registered again is replaced
    for alias in ("mediapipe", "graph.ntu_rgb_d.Graph", "ntu120"):
        assert graphs.get_graph(alias).name == jax_topology.get_graph(
            alias).name
    for lookup in (graphs.get_graph, jax_topology.get_graph):
        with pytest.raises(KeyError, match="unknown skeleton graph"):
            lookup(f"tree{v}_missing")
    graphs.register_graph(dataclasses.replace(got, center_joint=(1,)))
    try:
        assert graphs.get_graph(name).center_joint == (1,)
    finally:
        graphs.register_graph(got)
    assert graphs.get_graph(name) is got


def _write_joints(root, v: int, n: int, seed: int, split: str = "train"):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    data = rng.standard_normal((n, 3, T, v, 1)).astype(np.float32) * 0.1
    data[:, 0] += labels[:, None, None, None] * 0.3
    path = os.path.join(root, f"{split}_data_joint.npy")
    np.save(path, data)
    label_path = os.path.join(root, f"{split}_label.pkl")
    with open(label_path, "wb") as f:
        pickle.dump(([f"clip{i}" for i in range(n)], labels.tolist()), f)
    return {"data_path": path, "label_path": label_path}


def test_registered_name_resolves_everywhere(tmp_path):
    v, name = 160, "tree160"
    graph = graphs.get_graph(name)
    args = {"num_class": 2, "num_person": 1, "graph": name,
            "blocks": BLOCKS}
    # the model configs take V from the graph, as the reference's does
    cfg = config_from_reference_args(args)
    assert (cfg.num_point, cfg.graph) == (v, name)
    assert jax_model.config_from_reference_args(args).num_point == v
    st_cfg = stgcn.config_from_args({**args, "channels": [8],
                                     "strides": [1]})
    assert (st_cfg.num_point, st_cfg.graph) == (v, name)
    np.testing.assert_array_equal(
        stgcn.Model(st_cfg, device="cpu").A.numpy(), graph.A)
    # the pipeline's default config
    assert EnsemblePredictor({}, graph=name, device="cpu").config.num_point \
        == v

    # the modality CLI: the bone file byte for byte the reference's
    for package, root in ((modality_cli, tmp_path / "port"),
                          (jax_modality_cli, tmp_path / "ref")):
        root.mkdir()
        _write_joints(str(root), v, 3, seed=0)
        package.gen_bone(str(root), name, "train", chunk=2)
    bone = "train_data_bone.npy"
    assert ((tmp_path / "port" / bone).read_bytes()
            == (tmp_path / "ref" / bone).read_bytes())

    # the Trainer: one epoch of the registered graph's clips, and the
    # four-stream Trainer's bone parents
    paths = _write_joints(str(tmp_path), v, 8, seed=1)
    paths = {"data_path": paths["data_path"],
             "label_path": paths["label_path"]}
    argv = ["--config", os.path.join(REPO, "configs", "smoke.yaml"),
            "--work_dir", str(tmp_path / "work"),
            "--model_saved_name", str(tmp_path / "save"),
            "--train_feeder_args", repr(paths),
            "--test_feeder_args", repr(paths), "--model_args", repr(args),
            "--batch_size", "4", "--test_batch_size", "4",
            "--num_epoch", "1", "--save_interval", "1",
            "--eval_interval", "1", "--log_interval", "100"]
    best = cli_train.main(argv + ["--torch-device", "cpu"])
    assert 0.0 <= best <= 1.0
    scores = tmp_path / "work" / "smoke" / "eval_results" / "best_acc.pkl"
    with open(scores, "rb") as f:
        assert all(s.shape == (2,) and np.isfinite(s).all()
                   for s in pickle.load(f).values())
    four = Trainer(config.load_config(
        argv + ["--fourstream", "true", "--work_dir",
                str(tmp_path / "work4")]), device="cpu")
    assert four.model_config.num_point == v
    np.testing.assert_array_equal(four.parents.numpy(),
                                  graph.bone_parents())


@pytest.mark.parametrize("lowering", ["default", "pallas"])
@pytest.mark.parametrize("v", JOINTS)
def test_shift_gcn_past_the_frame_tile_matches_reference(interpret, v,
                                                         lowering):
    args = {"num_class": 2, "num_person": 1, "graph": f"tree{v}",
            "blocks": BLOCKS}
    cfg = jax_model.config_from_reference_args(args)
    if lowering == "pallas":
        # the fused Shift-GCN Pallas kernel, whose block takes any V
        cfg = dataclasses.replace(cfg, use_pallas=True)
    assert cfg.num_point == v
    params, bn_state = jax_model.init_params(jax.random.key(v), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    bn_state = jax.tree_util.tree_map(np.asarray, bn_state)
    rng = np.random.default_rng(v)
    data = rng.standard_normal((2, 3, T, v, 1)).astype(np.float32)
    label = np.asarray([0, 1], np.int32)

    def loss_fn(p):
        logits, _ = jax_model.apply(p, bn_state, jnp.asarray(data), cfg,
                                    training=True)
        return jax_state.cross_entropy(logits, jnp.asarray(label)), logits

    # the train step's forward (batch statistics), loss and gradients
    (ref_loss, ref_logits), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    model = Model(config_from_reference_args(args), device="cpu")
    model.load_state_dict(state_dict_from_arrays(params, bn_state),
                          strict=True)
    model.train()
    logits = model(torch.from_numpy(data))
    loss = state.cross_entropy(logits, torch.from_numpy(label).long())
    loss.backward()
    scale = max(1.0, float(np.abs(ref_logits).max()))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), rtol=0,
                               atol=1e-5 * scale)
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * max(
        1.0, abs(float(ref_loss)))
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    _assert_grads(_flat(jax.tree_util.tree_map(np.asarray, ref_grads)),
                  grads, 1e-5, 2e-4)
