"""2s-AGCN, the joint stream (Shi et al., CVPR 2019): its weights, work
counts and plain reference.

Weights.  The names and shapes are those of the source repository's
``state_dict`` (``model/agcn.py``, ``model.agcn.Model``), which the port
loads as they are and the reference reads.  Scaled to the source's
initialization: 1x1 and temporal convs kaiming-normal over fan-out,
``conv_d`` N(0, 2 / (C_out * C_in * 3)), conv biases zero, the classifier
N(0, 2 / classes) with torch's U(+-1/sqrt(in)) bias.  Three draws depart
from it, so that the comparison sees the attention (the configuration's
``weight_draws``, stated under ``assumed``): the GCN's BN weight is 1
(published 1e-6, which scales the whole GCN branch to ~1e-6), PA is
N(0, ``pa_std``^2) (published 1e-6), and theta and phi (``conv_a``,
``conv_b``) are the fan-out draw times the unit's entry of
``embedding_gain`` (the last entry for any unit past the list), so that
the attention's logits spread by about 1 on the benchmark's clips (the
published draw gives a near-uniform softmax).  BN is otherwise the identity.

Work.  MFU counts multiply-adds (2 FLOPs each): per unit the embeddings
(C_in -> 2*K*d a node), the attention's contraction (K*V^2*d a frame),
the aggregation x @ G_k (K*V^2*C_in a frame), ``conv_d`` (K*C_in*C_out a
node), the down conv, the 9-tap temporal conv and the residual conv;
the classifier.  The roofline's ops are the adjacency's, whatever kernels
do them: ``adjacency`` (forward: the embeddings, A and PA read, G
written; 2*N'*K*d*T*V^2 FLOPs) and ``adjacency_grad`` (backward: the
embeddings, P and dG read, their gradient written; twice the FLOPs).

Reference.  Written from the paper's equations and ``model/agcn.py``, in
its layout (N*M, C, T, V) and with its per-subset loop: data BN over the
M*V*C features of (N, M*V*C, T); per unit the GCN (per subset the
attention Softmax(-2)(conv_a x . conv_b x / (d*T)) plus A_k + PA_k, then
``conv_d`` of x @ G_k, summed; BN; plus the down branch; ReLU), the TCN
(a 9x1 conv at the unit's stride, BN), the residual (none, x, or a
strided 1x1 conv and BN), ReLU; the mean over (T', V) and persons; the
classifier.  Departures: the fixed adjacency A, a buffer of the published
model and no leaf here, is built from the configuration's inward edges
(``graph.inward``, the published ``graph/ntu_rgb_d.py``'s pairs, 0-indexed)
as the published ``graph/tools.py`` builds it.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from benchmark.reference.model import FP32, Precision, Weights, batch_norm
from benchmark.weights import Leaf, bn_leaves

MODEL = "agcn2s"
SUBSETS = 3
COFF_EMBEDDING = 4
TEMPORAL_KERNEL = 9
GROUPS = ("adjacency", "adjacency_grad")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def units(config: dict):
    """(index, cin, cout, stride, residual kind) of each unit."""
    for i, (cin, cout, stride, residual) in enumerate(config["backbone"]):
        kind = ("none" if not residual else
                "conv" if (cin != cout or stride != 1) else "identity")
        yield i + 1, int(cin), int(cout), int(stride), kind


def embedding_width(cout: int) -> int:
    return max(1, cout // COFF_EMBEDDING)


def leaves(config: dict) -> List[Leaf]:
    args = config["model_args"]
    v, m = args["num_point"], args["num_person"]
    c_in, ncls = config["in_channels"], args["num_class"]
    draws = config["weight_draws"]
    out: List[Leaf] = bn_leaves("data_bn", m * v * c_in)
    feat = c_in
    for i, cin, cout, stride, kind in units(config):
        p = f"l{i}.gcn1"
        d = embedding_width(cout)
        gains = draws["embedding_gain"]
        gain = gains[min(i, len(gains)) - 1]
        out.append((f"{p}.PA", (SUBSETS, v, v), "normal", draws["pa_std"]))
        for branch in ("conv_a", "conv_b"):
            for k in range(SUBSETS):
                out += [(f"{p}.{branch}.{k}.weight", (d, cin, 1, 1),
                         "normal", gain * math.sqrt(2.0 / d)),
                        (f"{p}.{branch}.{k}.bias", (d,), "zeros", 0.0)]
        for k in range(SUBSETS):
            out += [(f"{p}.conv_d.{k}.weight", (cout, cin, 1, 1), "normal",
                     math.sqrt(2.0 / (cout * cin * SUBSETS))),
                    (f"{p}.conv_d.{k}.bias", (cout,), "zeros", 0.0)]
        if cin != cout:
            out += [(f"{p}.down.0.weight", (cout, cin, 1, 1), "normal",
                     math.sqrt(2.0 / cout)),
                    (f"{p}.down.0.bias", (cout,), "zeros", 0.0)]
            out += bn_leaves(f"{p}.down.1", cout)
        out += bn_leaves(f"{p}.bn", cout)
        out += [(f"l{i}.tcn1.conv.weight", (cout, cout, TEMPORAL_KERNEL, 1),
                 "normal", math.sqrt(2.0 / (cout * TEMPORAL_KERNEL))),
                (f"l{i}.tcn1.conv.bias", (cout,), "zeros", 0.0)]
        out += bn_leaves(f"l{i}.tcn1.bn", cout)
        if kind == "conv":
            out += [(f"l{i}.residual.conv.weight", (cout, cin, 1, 1),
                     "normal", math.sqrt(2.0 / cout)),
                    (f"l{i}.residual.conv.bias", (cout,), "zeros", 0.0)]
            out += bn_leaves(f"l{i}.residual.bn", cout)
        feat = cout
    out += [("fc.weight", (ncls, feat), "normal", math.sqrt(2.0 / ncls)),
            ("fc.bias", (ncls,), "uniform", 1.0 / math.sqrt(feat))]
    return out


# ---------------------------------------------------------------------------
# work
# ---------------------------------------------------------------------------


def unit_shapes(config: dict):
    """Per unit: (t_in, t_out, cin, cout, d, residual kind)."""
    t = config["frames"]
    for _, cin, cout, stride, kind in units(config):
        t_out = -(-t // stride)
        yield t, t_out, cin, cout, embedding_width(cout), kind
        t = t_out


def forward_macs(config: dict) -> float:
    """Multiply-adds of one clip's forward pass."""
    args = config["model_args"]
    v, m, k = args["num_point"], args["num_person"], SUBSETS
    macs = 0.0
    for t_in, t_out, cin, cout, d, kind in unit_shapes(config):
        nodes = m * t_in * v
        macs += nodes * cin * 2 * k * d            # embeddings
        macs += m * t_in * k * v * v * d           # attention contraction
        macs += m * t_in * k * v * v * cin         # x @ G_k
        macs += nodes * k * cin * cout             # conv_d
        if cin != cout:
            macs += nodes * cin * cout             # down conv
        macs += m * t_out * v * cout * cout * TEMPORAL_KERNEL
        if kind == "conv":
            macs += m * t_out * v * cin * cout     # residual conv
    feat = config["backbone"][-1][1]
    return macs + feat * args["num_class"]


def ops(config: dict, clips: int, itemsize: int, training: bool) -> list:
    """(op, bytes, flops) of the adjacency of every unit, one forward
    (``training`` False) or one training step of ``clips`` clips."""
    args = config["model_args"]
    v, k = args["num_point"], SUBSETS
    n = clips * args["num_person"]
    out = []
    for t_in, _, _, _, d, _ in unit_shapes(config):
        emb = n * v * t_in * 2 * k * d * itemsize
        graph = n * k * v * v * 4
        flops = 2.0 * n * k * d * t_in * v * v
        out.append(("adjacency", emb + 2 * k * v * v * 4 + graph, flops))
        if training:
            out.append(("adjacency_grad", 2 * emb + 2 * graph, 2 * flops))
    return out


# ---------------------------------------------------------------------------
# reference
# ---------------------------------------------------------------------------


def spatial_adjacency(v: int, inward, device) -> torch.Tensor:
    """(3, V, V): the identity, the inward and the outward edges, each with
    A[j, i] = 1 for an edge (i, j) and each column divided by its sum."""

    def normalized(edges):
        a = torch.zeros(v, v, dtype=torch.float64)
        for i, j in edges:
            a[j, i] = 1.0
        total = a.sum(0)
        return a / torch.where(total > 0, total, torch.ones_like(total))

    eye = torch.eye(v, dtype=torch.float64)
    return torch.stack([eye, normalized(inward), normalized(
        [(j, i) for i, j in inward])]).float().to(device)


def conv(x, w, prefix, prec, stride: int = 1):
    """nn.Conv2d with a (k, 1) kernel, padding ((k - 1) // 2, 0)."""
    weight = w[prefix + ".weight"]
    return F.conv2d(prec.operand(x), prec.operand(weight), w[prefix + ".bias"],
                    stride=(stride, 1),
                    padding=((weight.shape[2] - 1) // 2, 0))


def unit_gcn(x, w, p, adjacency, training, prec):
    n, c, t, v = x.shape
    adj = adjacency + w[p + ".PA"]
    y = None
    for i in range(SUBSETS):
        a1 = conv(x, w, f"{p}.conv_a.{i}", prec)
        d = a1.shape[1]
        a1 = a1.permute(0, 3, 1, 2).reshape(n, v, d * t)
        a2 = conv(x, w, f"{p}.conv_b.{i}", prec).reshape(n, d * t, v)
        attn = torch.softmax(prec.matmul(a1, a2) / a1.shape[-1], dim=-2)
        z = prec.matmul(x.reshape(n, c * t, v), attn + adj[i])
        z = prec.act(conv(z.reshape(n, c, t, v), w, f"{p}.conv_d.{i}", prec))
        y = z if y is None else z + y
    y = prec.act(batch_norm(y, w, p + ".bn", training))
    if p + ".down.0.weight" in w:
        down = prec.act(batch_norm(conv(x, w, p + ".down.0", prec), w,
                                   p + ".down.1", training))
    else:
        down = x
    return prec.act(torch.relu(y + down))


def forward(w: Weights, x: torch.Tensor, config: dict, training: bool,
            prec: Precision = FP32) -> torch.Tensor:
    """x (N, C, T, V, M) fp32 -> logits (N, classes) fp32."""
    n, c, t, v, m = x.shape
    adjacency = spatial_adjacency(v, config["graph"]["inward"], x.device)
    h = x.permute(0, 4, 3, 1, 2).reshape(n, m * v * c, t)
    h = batch_norm(h, w, "data_bn", training)
    h = h.reshape(n, m, v, c, t).permute(0, 1, 3, 4, 2).reshape(
        n * m, c, t, v)
    h = prec.act(h)
    for i, cin, cout, stride, kind in units(config):
        p = f"l{i}"
        out = conv(unit_gcn(h, w, p + ".gcn1", adjacency, training, prec), w,
                   p + ".tcn1.conv", prec, stride)
        out = prec.act(batch_norm(prec.act(out), w, p + ".tcn1.bn",
                                  training))
        if kind == "none":
            res = 0
        elif kind == "identity":
            res = h
        else:
            res = prec.act(batch_norm(conv(h, w, p + ".residual.conv", prec,
                                           stride), w, p + ".residual.bn",
                                      training))
        h = prec.act(torch.relu(out + res))
    feat = h.shape[1]
    pooled = h.reshape(n, m, feat, -1).mean(3).mean(1)
    return (prec.matmul(pooled, w["fc.weight"].t()) + w["fc.bias"]).float()
