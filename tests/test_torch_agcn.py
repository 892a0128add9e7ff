"""The port's 2s-AGCN (``agcn2s``, ``models/agcn.py``) against the plain
published forward pass (``tests/agcn_reference.py``) on the CPU, at a
small size: the NTU graph (V=25), three units of 8-16 channels, T=16,
N=2, M=2.  Its adjacency op's CPU path against the reference's
per-subset attention; the registry's names; a Trainer step from a YAML
that names ``model.agcn.Model``.  The kernels are held to the same plain
versions on the card by ``test_torch_agcn_card.py``."""

import importlib.util
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from shift_gcn_torch import kernels
from shift_gcn_torch.graphs import get_graph
from shift_gcn_torch.models import agcn, registry
from shift_gcn_torch.ops import adaptive
from shift_gcn_torch.train import config as config_lib
from shift_gcn_torch.train.trainer import Trainer
from shift_gcn_torch.utils import trace

HERE = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location(
    "agcn_reference", HERE / "agcn_reference.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

BLOCKS = [[3, 8, 1, False], [8, 16, 2, True], [16, 16, 1, True]]
ARGS = {"num_class": 5, "num_point": 25, "num_person": 2,
        "graph": "ntu_rgb_d", "blocks": BLOCKS}

# the same sums in another order (cuBLAS-free CPU matmuls, the reference's
# per-subset loop against the port's batched products): fp64 round-off
# summed over a few thousand products, and fp32's the same at 2^-24,
# amplified by BN's 1/std and the softmax
TOL = {torch.float64: 1e-10, torch.float32: 2e-4}


@pytest.fixture(autouse=True)
def no_onednn():
    # torch's oneDNN convolution backward corrupts the heap on the CPU once
    # the reference package's compiled XLA code has run in the same process
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = saved


def seeded_model(dtype, seed=0):
    """A small model whose every parameter is N(0, 0.5^2): the attention
    far from uniform, PA and the GCN's BN weight well away from the
    published 1e-6."""
    model = agcn.Model(agcn.config_from_args(ARGS), device="cpu").to(dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, dtype=dtype) * 0.5)
    return model


def clips(dtype, n=2, t=16, seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 3, t, 25, 2, generator=gen, dtype=dtype)
    return x, torch.randint(0, 5, (n,), generator=gen)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_model_matches_the_published_forward(dtype, training):
    """Logits and loss, and in training every leaf's gradient, on the same
    weights (running statistics drawn away from 0 / 1 for eval)."""
    model = seeded_model(dtype)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 2.0)
            elif name.endswith("running_mean"):
                buf.normal_(0.0, 0.3)
    model.train(training)
    x, y = clips(dtype)
    w = {k: v.detach().clone().requires_grad_(v.is_floating_point())
         for k, v in model.state_dict().items()}
    assert set(w) == {n for n, _ in model.named_parameters()} | {
        n for n, _ in model.named_buffers() if not n.endswith(".A")}
    logits = model(x)
    want = ref.forward(w, x, training, blocks=BLOCKS)
    scale = float(want.detach().abs().max())
    assert float((logits - want).detach().abs().max()) <= TOL[dtype] * scale
    loss, want_loss = F.cross_entropy(logits, y), F.cross_entropy(want, y)
    assert abs(float((loss - want_loss).detach())) <= \
        TOL[dtype] * float(want_loss.detach())
    if not training:
        return
    loss.backward()
    want_loss.backward()
    norms = {n: float(w[n].grad.norm()) for n, _ in model.named_parameters()}
    median = float(np.median(list(norms.values())))
    for name, p in model.named_parameters():
        err = float((p.grad - w[name].grad).norm())
        # a leaf whose gradient is round-off (a conv bias ahead of a BN,
        # conv_a's bias under the source softmax) against the median leaf
        assert err <= TOL[dtype] * max(norms[name], median), name


def published_attention(x, w, prefix, k):
    """The reference's C_0..C_{k-1} of a unit_gcn, (N', K, V, V)."""
    with torch.no_grad():
        return torch.stack([ref.attention(x, w, prefix, i)
                            for i in range(k)], 1)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("unit", [1, 2], ids=["l1", "l2"])
def test_adjacency_op_is_the_published_attention(dtype, unit):
    """The op's G less A and PA against the reference's softmax over
    source joints; the softmax over target joints differs from both by
    far more than the tolerance, so the axis is pinned."""
    model = seeded_model(dtype)
    gcn = getattr(model, f"l{unit}").gcn1
    cin = gcn.conv_a[0].weight.shape[1]
    gen = torch.Generator().manual_seed(3)
    # inputs of std 4: logits that spread well past 1
    x = torch.randn(4, 25, 12, cin, generator=gen, dtype=dtype) * 4
    k = gcn.A.shape[0]
    branches = [*gcn.conv_a, *gcn.conv_b]
    with torch.no_grad():
        e = torch.cat([F.linear(x, c.weight.reshape(-1, cin), c.bias)
                       for c in branches], -1)
        g = adaptive.agcn_adjacency(e, gcn.A, gcn.PA, k)
    w = {f"p.{n}": t for n, t in gcn.state_dict().items()}
    want = published_attention(x.permute(0, 3, 2, 1), w, "p", k)
    got = (g - (gcn.A + gcn.PA)).detach()
    assert float((got - want).abs().max()) <= TOL[dtype]
    # columns (over source joints v) sum to one, rows do not
    assert torch.allclose(got.sum(2), torch.ones_like(got[:, :, 0]))
    n, v, t, _ = e.shape
    d = e.shape[-1] // (2 * k)
    emb = e.reshape(n, v, t, 2, k, d)
    s = torch.einsum("nvtkc,nutkc->nkvu", emb[:, :, :, 0],
                     emb[:, :, :, 1]) / (d * t)
    assert float((torch.softmax(s, 3) - want).abs().max()) > 0.1


def test_adjacency_op_gradients():
    """The op's analytic backward (the CPU path of the backward kernel)
    against finite differences, fp64, at V=7 with K=2 subsets."""
    gen = torch.Generator().manual_seed(4)
    e = torch.randn(2, 7, 5, 2 * 2 * 3, generator=gen,
                    dtype=torch.float64).requires_grad_(True)
    a = torch.rand(2, 7, 7, generator=gen, dtype=torch.float64)
    pa = (torch.randn(2, 7, 7, generator=gen, dtype=torch.float64)
          * 0.1).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda e, pa: adaptive.agcn_adjacency(e, a, pa, 2), (e, pa))


def test_adjacency_op_opens_its_spans_and_launches_nothing_on_cpu():
    trace.reset()
    kernels.reset_launches()
    model = seeded_model(torch.float32).train()
    x, y = clips(torch.float32)
    F.cross_entropy(model(x), y).backward()
    spans = trace.snapshot()
    assert spans["agcn.adjacency"]["count"] == len(BLOCKS)
    assert spans["agcn.adjacency_grad"]["count"] == len(BLOCKS)
    assert kernels.LAUNCHES["agcn_adjacency"] == 0
    assert kernels.LAUNCHES["agcn_adjacency_backward"] == 0


@pytest.mark.parametrize("v,ok", [(25, True), (33, True), (64, True),
                                  (65, False)])
def test_adjacency_plan_takes_up_to_64_joints(v, ok):
    if ok:
        plan = adaptive.adjacency_plan(128, v, 300, 3, 16)
        assert plan.vp % 4 == 0 and plan.vp >= v
        assert plan.fc % plan.fs == 0 and plan.chunks * plan.fc >= 300
        assert (plan.chunks - 1) * plan.fc < 300
    else:
        with pytest.raises(ValueError, match="65 joints"):
            adaptive.adjacency_plan(128, v, 300, 3, 16)


@pytest.mark.parametrize("d,ok", [(4, True), (16, True), (64, True),
                                  (2, False), (6, False)])
def test_adjacency_plan_takes_widths_in_fours(d, ok):
    if ok:
        assert adaptive.adjacency_plan(128, 25, 300, 3, d).fs * d <= 64
    else:
        with pytest.raises(ValueError, match=f"d={d} embedding channels"):
            adaptive.adjacency_plan(128, 25, 300, 3, d)


def test_registry_names():
    family = registry.get_model("model.agcn.Model")
    assert family.name == "agcn2s" and family.build is agcn.Model
    assert family.skeleton
    assert registry.get_model("shift_gcn_torch.models.agcn").name == "agcn2s"
    # the short alias stays the reference package's ST-GCN
    assert registry.get_model("agcn").name == "stgcn"


def test_published_yaml_builds_the_published_model():
    path = HERE.parent / "configs" / "nturgbd-cross-subject" / \
        "train_joint_agcn.yaml"
    cfg = config_lib.load_config(["--config", str(path)])
    family = registry.get_model(cfg.model)
    config = family.build_config(cfg.model_args)
    assert family.name == "agcn2s"
    assert config.blocks == agcn.PUBLISHED_BLOCKS
    assert (config.num_class, config.num_point, config.num_person) == \
        (60, 25, 2)
    assert (cfg.base_lr, cfg.step, cfg.batch_size) == (0.1, [30, 40], 64)
    model = family.build(config, device="cpu")
    # the published model.agcn.Model's parameters at num_class 60 (the
    # paper's 3.47M a stream)
    assert sum(p.numel() for p in model.parameters()) == 3469510
    gen = torch.Generator().manual_seed(0)
    model.init_weights(gen)
    gcn = model.l5.gcn1
    assert torch.all(gcn.PA == 1e-6) and torch.all(gcn.bn.weight == 1e-6)
    assert torch.equal(gcn.A, torch.from_numpy(get_graph("ntu_rgb_d").A))
    assert torch.equal(gcn.A, ref.spatial_adjacency(25, ref.NTU_INWARD))
    # conv_d: N(0, 2 / (C_out * C_in * 3)) with C_in 64, C_out 128
    std = float(torch.cat([c.weight.detach().flatten()
                           for c in gcn.conv_d]).std())
    assert abs(std / (2.0 / (128 * 64 * 3)) ** 0.5 - 1) < 0.02


def test_trainer_step_from_a_yaml_naming_model_agcn(tmp_path):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, 8)
    data = rng.standard_normal((8, 3, 16, 25, 2)).astype(np.float32)
    paths = {"data_path": str(tmp_path / "data.npy"),
             "label_path": str(tmp_path / "label.pkl")}
    np.save(paths["data_path"], data)
    with open(paths["label_path"], "wb") as f:
        pickle.dump(([f"s{i}" for i in range(8)], labels.tolist()), f)
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump({
        "Experiment_name": "agcn", "model": "model.agcn.Model",
        "model_args": ARGS, "work_dir": str(tmp_path / "wd"),
        "model_saved_name": str(tmp_path / "sm"),
        "train_feeder_args": paths, "test_feeder_args": paths,
        "batch_size": 8, "test_batch_size": 8, "num_epoch": 1,
        "base_lr": 0.1, "device_guard": False}))
    trainer = Trainer(config_lib.load_config(["--config", str(path)]),
                      device="cpu")
    assert isinstance(trainer.model, agcn.Model)
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    stats = trainer.train_epoch(0)
    assert len(stats["losses"]) == 1 and np.isfinite(stats["losses"]).all()
    moved = [n for n, p in trainer.model.named_parameters()
             if not torch.equal(p, before[n])]
    assert "l1.gcn1.PA" in moved and "fc.weight" in moved
    assert os.path.exists(os.path.join(trainer.work_dir, "agcn.py"))
