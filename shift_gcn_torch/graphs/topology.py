"""Skeleton graph topologies.

A copy of the reference package's ``SkeletonGraph``: the joint count, the
bone pairs that derive the bone modality (reference:
data_gen/gen_bone_data.py:5-30, data_gen/gen_bone_data_mediapipe.py:7-43),
the joints that pre-normalization centres and aligns, the inward edges
(which ``inference/render.py`` draws), and the spatial adjacency stack
``A`` (I / normalized inward / normalized outward, reference:
graph/tools.py:4-27) with its COO form.  The Shift-GCN forward never uses
the adjacency (reference: model/shift_gcn.py:121-142, only ``num_point``
matters); the ST-GCN family (``models/stgcn.py``) aggregates over ``A``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

Edge = Tuple[int, int]


def edge_matrix(edges: Sequence[Edge], num_nodes: int) -> np.ndarray:
    """Dense adjacency with A[target, source] = 1 (reference: graph/tools.py:4-8)."""
    a = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    for src, dst in edges:
        a[dst, src] = 1.0
    return a


def normalize_columns(a: np.ndarray) -> np.ndarray:
    """Column-normalize a digraph adjacency: A @ D^-1 (reference: graph/tools.py:11-19)."""
    col_sum = a.sum(axis=0)
    inv = np.where(col_sum > 0, 1.0 / np.where(col_sum > 0, col_sum, 1.0), 0.0)
    return a * inv[None, :]


def spatial_adjacency(num_nodes: int, inward: Sequence[Edge]) -> np.ndarray:
    """Stack (I, norm(inward), norm(outward)) -> (3, V, V) float32.

    Matches reference graph/tools.py:22-27 with self-links as identity.
    """
    self_link = [(i, i) for i in range(num_nodes)]
    outward = [(j, i) for (i, j) in inward]
    eye = edge_matrix(self_link, num_nodes)
    a_in = normalize_columns(edge_matrix(inward, num_nodes))
    a_out = normalize_columns(edge_matrix(outward, num_nodes))
    return np.stack([eye, a_in, a_out]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SkeletonGraph:
    """Immutable skeleton topology.

    Attributes:
      name: registry key.
      num_nodes: number of joints V.
      bone_pairs: (joint, parent) pairs for bone-vector derivation; roots map
        to themselves (bone = 0 for roots that self-reference after subtract,
        except reference NTU keeps the raw joint for unlisted roots).
      center_joint: joint index/indices used for centering in pre-normalization.
      zaxis: (bottom, top) joint pair aligned to z during pre-normalization.
      xaxis: (right, left) joint pair aligned to x during pre-normalization.
      inward: (child, parent) edges, 0-indexed, pointing toward the root:
        the skeleton the adjacency is built from and the annotated video
        draws.
    """

    name: str
    num_nodes: int
    bone_pairs: Tuple[Edge, ...]
    center_joint: Tuple[int, ...] = (1,)
    zaxis: Tuple[int, int] = (0, 1)
    xaxis: Tuple[int, int] = (8, 4)
    inward: Tuple[Edge, ...] = ()

    @property
    def outward(self) -> Tuple[Edge, ...]:
        return tuple((j, i) for (i, j) in self.inward)

    @property
    def neighbor(self) -> Tuple[Edge, ...]:
        return self.inward + self.outward

    @property
    def A(self) -> np.ndarray:
        """(3, V, V) spatial adjacency stack, float32."""
        return spatial_adjacency(self.num_nodes, self.inward)

    def bone_parents(self) -> np.ndarray:
        """parents[v] = parent joint of v (v itself for roots). Shape (V,)."""
        parents = np.arange(self.num_nodes)
        for child, parent in self.bone_pairs:
            parents[child] = parent
        return parents

    def coo(self) -> Dict[str, np.ndarray]:
        """COO form of the 3-subset adjacency: ``src``, ``dst``, ``weight``
        and ``subset`` arrays of equal length E, subset by subset, each in
        row-major (dst, src) order, for ``ops/aggregate.edge_aggregate``."""
        srcs, dsts, weights, subsets = [], [], [], []
        for k, mat in enumerate(self.A):
            dst_idx, src_idx = np.nonzero(mat)
            srcs.append(src_idx)
            dsts.append(dst_idx)
            weights.append(mat[dst_idx, src_idx])
            subsets.append(np.full(len(src_idx), k))
        return {
            "src": np.concatenate(srcs).astype(np.int32),
            "dst": np.concatenate(dsts).astype(np.int32),
            "weight": np.concatenate(weights).astype(np.float32),
            "subset": np.concatenate(subsets).astype(np.int32),
        }


def _ntu_inward() -> Tuple[Edge, ...]:
    # 1-indexed (child, parent) pairs toward the spine (reference:
    # graph/ntu_rgb_d.py:8-11), converted to 0-indexed.
    pairs_1 = [
        (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6),
        (8, 7), (9, 21), (10, 9), (11, 10), (12, 11), (13, 1),
        (14, 13), (15, 14), (16, 15), (17, 1), (18, 17), (19, 18),
        (20, 19), (22, 23), (23, 8), (24, 25), (25, 12),
    ]
    return tuple((i - 1, j - 1) for (i, j) in pairs_1)


def _mediapipe_inward() -> Tuple[Edge, ...]:
    # Spanning tree over 33 MediaPipe Pose landmarks rooted at NOSE with two
    # bridge edges (reference: graph/mediapipe_pose.py:14-24), 0-indexed.
    return (
        (1, 0), (2, 1), (3, 2), (7, 3),
        (4, 0), (5, 4), (6, 5), (8, 6),
        (9, 0), (10, 9),
        (11, 0), (12, 11),
        (13, 11), (15, 13), (17, 15), (19, 15), (21, 15),
        (14, 12), (16, 14), (18, 16), (20, 16), (22, 16),
        (23, 11), (24, 12),
        (25, 23), (27, 25), (29, 27), (31, 27),
        (26, 24), (28, 26), (30, 28), (32, 28),
    )


def _ntu_bone_pairs() -> Tuple[Edge, ...]:
    # reference: data_gen/gen_bone_data.py:5-30 (1-indexed, incl. (21,21) root)
    pairs_1 = [
        (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6), (8, 7),
        (9, 21), (10, 9), (11, 10), (12, 11), (13, 1), (14, 13), (15, 14),
        (16, 15), (17, 1), (18, 17), (19, 18), (20, 19), (22, 23), (21, 21),
        (23, 8), (24, 25), (25, 12),
    ]
    return tuple((i - 1, j - 1) for (i, j) in pairs_1)


def _mediapipe_bone_pairs() -> Tuple[Edge, ...]:
    # reference: data_gen/gen_bone_data_mediapipe.py:7-43 (1-indexed), includes
    # the (1, 1) NOSE self-pair so the root bone is zero.
    pairs_1 = [
        (1, 1), (2, 1), (3, 2), (4, 3), (5, 1), (6, 5), (7, 6), (8, 4),
        (9, 7), (10, 1), (11, 10), (12, 1), (13, 12), (14, 12), (15, 13),
        (16, 14), (17, 15), (18, 16), (19, 17), (20, 16), (21, 17), (22, 16),
        (23, 17), (24, 12), (25, 13), (26, 24), (27, 25), (28, 26), (29, 27),
        (30, 28), (31, 29), (32, 28), (33, 29),
    ]
    return tuple((i - 1, j - 1) for (i, j) in pairs_1)


NTU_RGB_D = SkeletonGraph(
    name="ntu_rgb_d",
    num_nodes=25,
    bone_pairs=_ntu_bone_pairs(),
    center_joint=(1,),
    zaxis=(0, 1),
    xaxis=(8, 4),
    inward=_ntu_inward(),
)

# NTU-120 shares the 25-joint skeleton; split logic differs (data layer).
NTU120_RGB_D = dataclasses.replace(NTU_RGB_D, name="ntu120_rgb_d")

MEDIAPIPE_POSE = SkeletonGraph(
    name="mediapipe_pose",
    num_nodes=33,
    bone_pairs=_mediapipe_bone_pairs(),
    # reference: data_gen/mediapipe_gendata.py:158 — center = hip midpoint,
    # zaxis = LEFT_HIP(23)->LEFT_SHOULDER(11), xaxis = RIGHT_SHOULDER(12)->LEFT_SHOULDER(11)
    center_joint=(23, 24),
    zaxis=(23, 11),
    xaxis=(12, 11),
    inward=_mediapipe_inward(),
)

_REGISTRY: Dict[str, SkeletonGraph] = {
    g.name: g for g in (NTU_RGB_D, NTU120_RGB_D, MEDIAPIPE_POSE)
}

# Dotted-path aliases so reference-style YAML configs
# (e.g. ``graph: graph.ntu_rgb_d.Graph``) resolve against the registry.
_ALIASES = {
    "graph.ntu_rgb_d.Graph": "ntu_rgb_d",
    "graph.ntu120_rgb_d.Graph": "ntu120_rgb_d",
    "graph.mediapipe_pose.Graph": "mediapipe_pose",
    "ntu": "ntu_rgb_d",
    "ntu120": "ntu120_rgb_d",
    "mediapipe": "mediapipe_pose",
}


def get_graph(name: str) -> SkeletonGraph:
    """Look up a topology by registry key or reference dotted path."""
    key = _ALIASES.get(name, name)
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown skeleton graph {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def register_graph(graph: SkeletonGraph) -> None:
    """Register a custom topology under ``graph.name``, replacing any
    topology of that name: ``get_graph`` and every consumer of a graph
    name (the model configs, the Trainer, four-stream's bone streams,
    the modality CLI, the pipeline, the tools) resolve it afterwards (the
    reference package's plug-in point, which replaces the reference's
    import-by-dotted-path at main.py:558-563)."""
    _REGISTRY[graph.name] = graph
