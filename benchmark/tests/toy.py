"""A copy of the benchmark at test sizes: every configuration cut to a
4-unit backbone of 16-32 channels at T=24, 32 training clips in batches
of 8, the report pool to 4 tracks of 300-700 frames.  The copy holds
``BENCHMARK.json`` and ``benchmark/`` and links the port, so that files
added to it are found as a later change's would be.  Below, a second family
for such a copy: the port's ST-GCN at V=5, with its plain reference."""

import copy
import json
import math
import shutil
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]
SMALL = [[3, 16, 1, False], [16, 16, 1, True], [16, 32, 2, True],
         [32, 32, 1, True]]


def small_config(config: dict) -> dict:
    config = copy.deepcopy(config)
    config.update(frames=24, backbone=SMALL, train_clips=32, val_clips=8)
    config["model_args"]["blocks"] = SMALL
    config["train"].update(batch_size=8, test_batch_size=8)
    return config


def make(dest: Path, port: bool = True) -> Path:
    dest = Path(dest)
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy2(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    if port:
        (dest / "shift_gcn_torch").symlink_to(ROOT / "shift_gcn_torch")
    manifest = json.loads((dest / "BENCHMARK.json").read_text())
    for entry in manifest["configs"]:
        path = dest / entry["file"]
        path.write_text(json.dumps(small_config(json.loads(
            path.read_text()))))
    mix = dest / "benchmark" / "traffic" / "report_tracks.json"
    params = json.loads(mix.read_text())
    params.update(pool=4, frames_min=300, frames_max=700,
                  calibration_windows=8, check_reports=2, profile_reports=1)
    mix.write_text(json.dumps(params))
    return dest


# ---------------------------------------------------------------------------
# a second family: the port's ST-GCN at V=5, with its plain reference
# ---------------------------------------------------------------------------

# (child, parent) edges of a 5-joint tree rooted at joint 0
TOY_INWARD = [[1, 0], [2, 1], [3, 1], [4, 0]]
TOY_TEMPORAL_KERNEL = 9     # the port's ST-GCN fixes its temporal kernel


def toy_stgcn_config() -> dict:
    """Two ST-GCN units (8 and 16 channels, the second strided) over a
    5-joint graph, M=1, T=16, fp32, batches of 8."""
    base = json.loads((ROOT / "benchmark" / "configs"
                       / "ntu60_xsub.json").read_text())
    return {
        "name": "toy_stgcn", "family": "toy_stgcn", "source": "a test",
        "model_args": {"num_class": 3, "num_point": 5, "num_person": 1,
                       "graph": "toy5", "channels": [8, 16],
                       "strides": [1, 2], "adaptive": True,
                       "adaptive_embed": 0},
        "in_channels": 3, "frames": 16,
        "activation_dtype": "float32", "serve_dtype": "float32",
        "train": dict(base["train"], batch_size=8, test_batch_size=8),
        "momentum": base["momentum"],
        "weight_decay_table": base["weight_decay_table"],
        "graph": {"inward": TOY_INWARD},
        "train_clips": 32, "val_clips": 8, "reduced": []}


def stgcn_adjacency(v: int, inward) -> torch.Tensor:
    """(3, V, V): the identity, then the inward and the outward edges,
    each column divided by its sum (A[target, source])."""
    a_in = torch.zeros(v, v)
    for child, parent in inward:
        a_in[parent, child] = 1.0

    def by_column(a):
        total = a.sum(0)
        return a / torch.where(total > 0, total, torch.ones_like(total))

    return torch.stack([torch.eye(v), by_column(a_in), by_column(a_in.t())])


def stgcn_leaves(config: dict):
    from benchmark.weights import bn_leaves

    args = config["model_args"]
    v, k = args["num_point"], 3
    out = bn_leaves("data_bn", args["num_person"] * v * config["in_channels"])
    cin = config["in_channels"]
    for i, cout in enumerate(args["channels"]):
        p = f"l{i + 1}"
        out += [(f"{p}.gcn_weight", (k, cin, cout), "normal",
                 math.sqrt(2.0 / (k * cout))),
                (f"{p}.gcn_bias", (cout,), "uniform", 0.1),
                (f"{p}.B", (k, v, v), "normal", 0.1),
                (f"{p}.tcn.weight", (cout, cout, TOY_TEMPORAL_KERNEL, 1),
                 "normal", math.sqrt(2.0 / (cout * TOY_TEMPORAL_KERNEL))),
                (f"{p}.tcn.bias", (cout,), "uniform", 0.1)]
        out += bn_leaves(f"{p}.bn1", cout) + bn_leaves(f"{p}.bn2", cout)
        if cin != cout:
            out += [(f"{p}.down.weight", (cout, cin, 1, 1), "normal",
                     math.sqrt(2.0 / cout)),
                    (f"{p}.down.bias", (cout,), "zeros", 0.0)]
            out += bn_leaves(f"{p}.down_bn", cout)
        cin = cout
    out += [("fc.weight", (args["num_class"], cin), "normal",
             math.sqrt(2.0 / args["num_class"])),
            ("fc.bias", (args["num_class"],), "uniform", 1.0 / math.sqrt(cin))]
    return out


def stgcn_forward(w, x, config, training, prec=None):
    """ST-GCN in plain PyTorch, layout (N*M, C, T, V): data BN over M*V*C
    features; per unit sum_k (A_k + B_k) X W_k + bias, BN, ReLU, a 9x1
    temporal conv at the unit's stride, BN, plus the residual (a 1x1
    conv where the width changes, every stride-th frame, then BN), ReLU;
    mean over (T', V) and persons, the classifier."""
    from benchmark.reference.model import FP32, batch_norm

    prec = prec or FP32
    args = config["model_args"]
    n, c, t, v, m = x.shape
    adjacency = stgcn_adjacency(v, config["graph"]["inward"]).to(x)
    h = x.permute(0, 4, 3, 1, 2).reshape(n, m * v * c, t)
    h = batch_norm(h, w, "data_bn", training)
    h = h.reshape(n, m, v, c, t).permute(0, 1, 3, 4, 2).reshape(
        n * m, c, t, v)
    for i, (cout, stride) in enumerate(zip(args["channels"],
                                           args["strides"])):
        p = f"l{i + 1}"
        adj = adjacency + w[p + ".B"]
        xw = torch.einsum("bctu,kcd->bkdtu", prec.operand(h),
                          prec.operand(w[p + ".gcn_weight"]))
        g = torch.einsum("kvu,bkdtu->bdtv", adj, xw)
        g = g + w[p + ".gcn_bias"][None, :, None, None]
        g = torch.relu(batch_norm(g, w, p + ".bn1", training))
        g = F.conv2d(prec.operand(g), prec.operand(w[p + ".tcn.weight"]),
                     w[p + ".tcn.bias"], stride=(stride, 1),
                     padding=((TOY_TEMPORAL_KERNEL - 1) // 2, 0))
        g = batch_norm(g, w, p + ".bn2", training)
        if h.shape[1] != cout:
            res = prec.conv1x1(h, w[p + ".down.weight"], w[p + ".down.bias"])
            res = batch_norm(res[:, :, ::stride], w, p + ".down_bn",
                             training)
        else:
            res = h[:, :, ::stride]
        h = prec.act(torch.relu(g + res))
    pooled = h.reshape(n, m, h.shape[1], -1).mean(3).mean(1)
    return (prec.matmul(pooled, w["fc.weight"].t()) + w["fc.bias"]).float()


def stgcn_macs(config: dict) -> float:
    """Multiply-adds of one clip's forward: per unit the K subsets'
    feature products and their V x V aggregations, the temporal conv and
    the down conv; the classifier."""
    args = config["model_args"]
    v, m, k = args["num_point"], args["num_person"], 3
    t, cin, macs = config["frames"], config["in_channels"], 0.0
    for cout, stride in zip(args["channels"], args["strides"]):
        macs += m * k * t * v * cin * cout + m * k * t * v * v * cout
        macs += m * (t // stride) * v * cout * cout * TOY_TEMPORAL_KERNEL
        if cin != cout:
            macs += m * t * v * cin * cout
        t, cin = t // stride, cout
    return macs + cin * args["num_class"]


# the family file that the toy architecture brings
TOY_FAMILY = '''"""A test's family: the port's ST-GCN, its reference in toy.py."""
from benchmark.tests.toy import stgcn_forward as forward  # noqa: F401
from benchmark.tests.toy import stgcn_leaves as leaves  # noqa: F401
from benchmark.tests.toy import stgcn_macs as forward_macs  # noqa: F401

MODEL = "stgcn"


def ops(config, clips, itemsize, training):
    return []
'''
