"""Graph aggregation ops: dense per-subset aggregation, the sparse COO
segment sum, and the sampled dense-dense products (SDDMM).

A copy of the reference package's ``ops/aggregate.py``.  There these are
XLA einsums, gathers and segment sums, never Pallas kernels, so here they
are stock PyTorch operations: ``torch.einsum`` for the dense products,
``index_select`` + ``index_add_`` for the segment sum.  The reference
accumulates every product in fp32 (``preferred_element_type``), so the
operands are taken to fp32 here and the results are fp32 (fp64 operands,
a float64 reference run's, stay fp64).

``index_add_`` on a CUDA tensor adds with atomics in no fixed order, so
``edge_aggregate`` there agrees with its CPU result to fp32 roundoff,
not bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Edges = Dict[str, torch.Tensor]


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or in fp64 if it is fp64: the accumulation type."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def dense_graph_aggregate(x: torch.Tensor, adjacency: torch.Tensor,
                          weight: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """out[..., v, d] = sum_k sum_u A[k, v, u] (x W_k)[..., u, d].

    x: (..., V, C_in); adjacency: (K, V, V); weight: optional
    (K, C_in, C_out).  Returns (..., V, C_out), C_out = C_in without
    ``weight``."""
    x = wide(x)
    adjacency = wide(adjacency)
    if weight is None:
        return torch.einsum("kvu,...uc->...vc", adjacency, x)
    h = torch.einsum("...uc,kcd->k...ud", x, wide(weight))
    return torch.einsum("kvu,k...ud->...vd", adjacency, h)


def edge_aggregate(x: torch.Tensor, edges: Edges,
                   num_nodes: int) -> torch.Tensor:
    """out[..., dst_e, c] += weight_e * x[..., src_e, c] over the COO
    edges (int ``src`` / ``dst`` (E,), float ``weight`` (E,)): a gather
    and a segment sum over the destination axis.  x: (..., V, C)."""
    gathered = x.index_select(-2, edges["src"].long())
    gathered = gathered * edges["weight"][:, None]
    out = gathered.new_zeros(gathered.shape[:-2]
                             + (num_nodes, gathered.shape[-1]))
    return out.index_add_(out.dim() - 2, edges["dst"].long(), gathered)


def sddmm(a: torch.Tensor, b: torch.Tensor, edges: Edges) -> torch.Tensor:
    """Per-edge scores <a[..., src_e, :], b[..., dst_e, :]> -> (..., E).
    a, b: (..., V, C)."""
    ga = a.index_select(-2, edges["src"].long())
    gb = b.index_select(-2, edges["dst"].long())
    return (ga * gb).sum(-1)


def sddmm_dense(a: torch.Tensor, b: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """(A @ B^T) * mask: a, b (..., V, C), mask (V, V) -> (..., V, V)."""
    scores = torch.einsum("...vc,...uc->...vu", wide(a), wide(b))
    return scores * mask


def edge_aggregate_onehot(x: torch.Tensor, edges: Edges,
                          num_nodes: int) -> torch.Tensor:
    """``edge_aggregate``'s contraction through a dense (V, V) matrix of
    the summed edge weights."""
    mat = torch.zeros((num_nodes, num_nodes), dtype=x.dtype,
                      device=x.device)
    mat.index_put_((edges["dst"].long(), edges["src"].long()),
                   edges["weight"].to(x.dtype), accumulate=True)
    return torch.einsum("vu,...uc->...vc", wide(mat), wide(x))
