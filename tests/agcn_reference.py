"""2s-AGCN's joint model in plain PyTorch, the published forward pass.

Written from Shi et al., "Two-Stream Adaptive Graph Convolutional
Networks for Skeleton-Based Action Recognition" (CVPR 2019) and
``github.com/lshiwjx/2s-AGCN`` ``model/agcn.py``, in its layout (N*M, C,
T, V) and with its per-subset loop: a test's oracle for the port's
``agcn2s`` family.  It imports nothing of the port or of the JAX package,
and computes in the input's dtype with TF32 off.

Departures from the published code, none of them in the arithmetic:
weights are a dict of the published state_dict's names, not modules; the
fixed adjacency A is built here from the inward edges (it is a buffer of
the published model, not a parameter); BN is written out, by the batch's
mean and biased variance in training and by the running statistics in
eval, and updates no running statistic.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

# (C_in, C_out, stride, residual) of the published units l1..l10
BLOCKS = ((3, 64, 1, False), (64, 64, 1, True), (64, 64, 1, True),
          (64, 64, 1, True), (64, 128, 2, True), (128, 128, 1, True),
          (128, 128, 1, True), (128, 256, 2, True), (256, 256, 1, True),
          (256, 256, 1, True))

# NTU RGB+D's inward edges (child, parent), 0-indexed: the published
# graph/ntu_rgb_d.py's 1-indexed pairs less one
NTU_INWARD = tuple((i - 1, j - 1) for i, j in (
    (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6), (8, 7),
    (9, 21), (10, 9), (11, 10), (12, 11), (13, 1), (14, 13), (15, 14),
    (16, 15), (17, 1), (18, 17), (19, 18), (20, 19), (22, 23), (23, 8),
    (24, 25), (25, 12)))


def spatial_adjacency(num_nodes: int,
                      inward: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """(3, V, V): the identity, the inward and the outward edges, each with
    A[j, i] = 1 for an edge (i, j) and each column divided by its sum
    (graph/tools.py's edge2mat and normalize_digraph), float32."""

    def normalized(edges):
        a = torch.zeros(num_nodes, num_nodes, dtype=torch.float64)
        for i, j in edges:
            a[j, i] = 1.0
        total = a.sum(0)
        return a / torch.where(total > 0, total, torch.ones_like(total))

    eye = torch.eye(num_nodes, dtype=torch.float64)
    return torch.stack([eye, normalized(inward),
                        normalized([(j, i) for i, j in inward])]).float()


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def batch_norm(x: torch.Tensor, w: Weights, prefix: str,
               training: bool) -> torch.Tensor:
    """BN over dim 1, eps 1e-5."""
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    if training:
        mean = x.mean(dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dims, keepdim=True)
    else:
        mean = w[prefix + ".running_mean"].reshape(shape)
        var = w[prefix + ".running_var"].reshape(shape)
    return ((x - mean) * torch.rsqrt(var + 1e-5)
            * w[prefix + ".weight"].reshape(shape)
            + w[prefix + ".bias"].reshape(shape))


def conv(x: torch.Tensor, w: Weights, prefix: str,
         stride: int = 1) -> torch.Tensor:
    """nn.Conv2d with a (k, 1) kernel, padding ((k - 1) // 2, 0)."""
    weight = w[prefix + ".weight"]
    return F.conv2d(x, weight, w[prefix + ".bias"], stride=(stride, 1),
                    padding=((weight.shape[2] - 1) // 2, 0))


def attention(x: torch.Tensor, w: Weights, prefix: str,
              i: int) -> torch.Tensor:
    """C_i (N, V, V) of unit_gcn: Softmax(-2) of conv_a x (N, V, d*T)
    times conv_b x (N, d*T, V), over d*T."""
    n, _, t, v = x.shape
    a1 = conv(x, w, f"{prefix}.conv_a.{i}")
    d = a1.shape[1]
    a1 = a1.permute(0, 3, 1, 2).contiguous().view(n, v, d * t)
    a2 = conv(x, w, f"{prefix}.conv_b.{i}").view(n, d * t, v)
    return torch.softmax(torch.matmul(a1, a2) / a1.size(-1), dim=-2)


def unit_gcn(x: torch.Tensor, w: Weights, prefix: str, adjacency,
             training: bool) -> torch.Tensor:
    n, c, t, v = x.shape
    a = adjacency.to(x) + w[prefix + ".PA"]
    y = None
    for i in range(a.shape[0]):
        a1 = attention(x, w, prefix, i) + a[i]
        z = conv(torch.matmul(x.reshape(n, c * t, v), a1).view(n, c, t, v),
                 w, f"{prefix}.conv_d.{i}")
        y = z if y is None else z + y
    y = batch_norm(y, w, prefix + ".bn", training)
    if prefix + ".down.0.weight" in w:
        down = batch_norm(conv(x, w, prefix + ".down.0"), w,
                          prefix + ".down.1", training)
    else:
        down = x
    return torch.relu(y + down)


def forward(w: Weights, x: torch.Tensor, training: bool,
            blocks=BLOCKS, inward=NTU_INWARD) -> torch.Tensor:
    """x (N, C, T, V, M) -> logits (N, classes)."""
    n, c, t, v, m = x.shape
    adjacency = spatial_adjacency(v, inward)
    with no_tf32():
        h = x.permute(0, 4, 3, 1, 2).contiguous().view(n, m * v * c, t)
        h = batch_norm(h, w, "data_bn", training)
        h = h.view(n, m, v, c, t).permute(0, 1, 3, 4, 2).contiguous().view(
            n * m, c, t, v)
        for i, (cin, cout, stride, residual) in enumerate(blocks):
            p = f"l{i + 1}"
            out = batch_norm(conv(unit_gcn(h, w, p + ".gcn1", adjacency,
                                           training), w, p + ".tcn1.conv",
                                  stride), w, p + ".tcn1.bn", training)
            if not residual:
                res = 0
            elif cin == cout and stride == 1:
                res = h
            else:
                res = batch_norm(conv(h, w, p + ".residual.conv", stride), w,
                                 p + ".residual.bn", training)
            h = torch.relu(out + res)
        feat = h.size(1)
        pooled = h.view(n, m, feat, -1).mean(3).mean(1)
        return F.linear(pooled, w["fc.weight"], w["fc.bias"])
