"""2s-AGCN's per-sample adaptive adjacency as one op.

For a unit's K subsets (Shi et al., CVPR 2019, ``model/agcn.py``
``unit_gcn``), from the embeddings ``a_k = theta_k x + alpha_k`` and
``b_k = phi_k x + beta_k`` of d = C_out / 4 channels each:

    S_k[n,v,u] = sum_{t<T, c<d} a_k[n,v,t,c] b_k[n,u,t,c] / (d*T),
    C_k[n,:,u] = softmax over v of S_k[n,:,u]   (the published Softmax(-2)),
    G_k[n]     = C_k[n] + (A_k + PA_k),

G[n,k,v,u] the weight of source joint v in target joint u (the published
``x @ A``).  The embeddings of all K subsets come in one tensor e of
shape (N', V, T, 2*K*d): per node the K a_k, then the K b_k.  The op
returns G (N', K, V, V); its backward gives de and dPA = sum_n dG (A is
fixed).

``agcn_adjacency`` is the autograd entry point (``AdjacencyFunction``,
which opens the spans ``agcn.adjacency`` and ``agcn.adjacency_grad``).
Its raw launchers, ``adjacency_forward`` and ``adjacency_backward``, run
the plain PyTorch versions (``adjacency_forward_reference``,
``adjacency_backward_reference``) on a CPU tensor, and the hand-written
kernels of ``csrc/adaptive.cu`` on a CUDA tensor (fp32 only), each
counting one launch in ``kernels.LAUNCHES`` (``agcn_adjacency``,
``agcn_adjacency_backward``).  The kernels take V up to ``MAX_V``, K
up to ``MAX_K`` and d a multiple of 4 (``adjacency_plan`` refuses
others).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from shift_gcn_torch import kernels
from shift_gcn_torch.utils import trace

# csrc/adaptive.cu: a forward block holds K * (VP / 4)^2 threads, the
# final pass a thread per target joint
MAX_V = 64
MAX_K = 4
# contraction entries (frames x channels) a stage of shared memory holds
STAGE = 64
# blocks the chunks of frames aim at: about four waves of an H100's 132
# SMs, fixed here so that the chunks, and so the order of the sums,
# depend on the shapes alone
TARGET_BLOCKS = 528
SMEM_LIMIT = 232448  # bytes of shared memory a block may use (H100)


def embedding_width(e: torch.Tensor, k: int) -> int:
    """d of embeddings e (..., 2*k*d)."""
    q = e.shape[-1]
    if q % (2 * k):
        raise ValueError(f"embeddings of {q} channels do not split into "
                         f"2 x {k} subsets")
    return q // (2 * k)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and the kernels' oracles on the card)
# ---------------------------------------------------------------------------


def adjacency_forward_reference(e: torch.Tensor, a: torch.Tensor,
                                pa: torch.Tensor, k: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(G, P) (N', K, V, V) from e (N', V, T, 2*K*d), A and PA (K, V, V):
    P the softmax over source joints, G = P + (A + PA)."""
    n, v, t, _ = e.shape
    d = embedding_width(e, k)
    emb = e.reshape(n, v, t, 2, k, d)
    s = torch.einsum("nvtkc,nutkc->nkvu", emb[:, :, :, 0],
                     emb[:, :, :, 1]) / (d * t)
    p = torch.softmax(s, dim=2)
    return p + (a + pa), p


def adjacency_backward_reference(e: torch.Tensor, p: torch.Tensor,
                                 dg: torch.Tensor) -> torch.Tensor:
    """de (the layout of e) from the forward's e and P and the cotangent
    dG: dS = P (dG - sum_v P dG) / (d*T), da = dS b, db = dS^T a."""
    n, v, t, q = e.shape
    k = p.shape[1]
    d = embedding_width(e, k)
    ds = p * (dg - (p * dg).sum(2, keepdim=True)) / (d * t)
    emb = e.reshape(n, v, t, 2, k, d)
    da = torch.einsum("nkvu,nutkc->nvtkc", ds, emb[:, :, :, 1])
    db = torch.einsum("nkvu,nvtkc->nutkc", ds, emb[:, :, :, 0])
    return torch.stack([da, db], dim=3).reshape(n, v, t, q)


# ---------------------------------------------------------------------------
# Raw launchers: plain version on a CPU tensor, kernels on a CUDA tensor
# ---------------------------------------------------------------------------


class AdjacencyPlan(NamedTuple):
    """The kernels' grid over (N', V, T, K, d): joints padded to ``vp``,
    ``fs`` frames a stage, ``fc`` frames (a multiple of fs) in each of
    ``chunks`` chunks, and each kernel's shared memory in bytes."""
    vp: int
    fs: int
    fc: int
    chunks: int
    forward_smem: int
    backward_smem: int


def adjacency_plan(n: int, v: int, t: int, k: int, d: int) -> AdjacencyPlan:
    """The plan of the kernels at these shapes; raises ValueError for
    shapes they do not take."""
    if not 1 <= v <= MAX_V:
        raise ValueError(f"agcn_adjacency: {v} joints; the kernels take "
                         f"1 to {MAX_V}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"agcn_adjacency: {k} subsets; the kernels take "
                         f"1 to {MAX_K}")
    if not (1 <= n <= 65535 and t >= 1 and d >= 1):
        raise ValueError(f"agcn_adjacency: no grid for N'={n}, T={t}, "
                         f"d={d}")
    if d % 4:
        raise ValueError(f"agcn_adjacency: d={d} embedding channels; the "
                         f"kernels take a multiple of 4")
    vp = -(-v // 4) * 4
    fs = max(1, STAGE // d)
    stages = -(-t // fs)
    chunks = max(1, min(-(-TARGET_BLOCKS // n), stages))
    fc = -(-stages // chunks) * fs
    plan = AdjacencyPlan(vp, fs, fc, -(-t // fc),
                         4 * 2 * k * fs * d * vp,
                         4 * (2 * k * v * vp + v * fs * 2 * k * d))
    if max(plan.forward_smem, plan.backward_smem) > SMEM_LIMIT:
        raise ValueError(
            f"agcn_adjacency: V={v}, K={k}, d={d} need "
            f"{max(plan.forward_smem, plan.backward_smem)} bytes of shared "
            f"memory a block; the card has {SMEM_LIMIT}")
    return plan


def _check_cuda(name: str, x: torch.Tensor, shape, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name}: {what} must be a contiguous "
                         f"{tuple(shape)} tensor")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a fresh copy where it does not start on 16 bytes: the
    kernels move four floats a load."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def adjacency_forward(e: torch.Tensor, a: torch.Tensor, pa: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The adjacency of e's K subsets: (G, P), each (N', K, V, V)."""
    name = "agcn_adjacency"
    kernels.refuse_grad(name, e, pa)
    if e.device.type == "cpu":
        return adjacency_forward_reference(e, a, pa, k)
    n, v, t, _ = e.shape
    d = embedding_width(e, k)
    plan = adjacency_plan(n, v, t, k, d)
    _check_cuda(name, e, e.shape, "e")
    for what, x in (("A", a), ("PA", pa)):
        _check_cuda(name, x, (k, v, v), what)
    g = torch.empty((n, k, v, v), dtype=torch.float32, device=e.device)
    p = torch.empty_like(g)
    partial = torch.empty(n * plan.chunks * k * v * v, dtype=torch.float32,
                          device=e.device)
    e = _aligned(e)
    status = kernels.launch(
        "adaptive", "agcn_adjacency_forward", e, e.data_ptr(), a.data_ptr(),
        pa.data_ptr(), partial.data_ptr(), p.data_ptr(), g.data_ptr(), n, v,
        t, k, d, plan.vp, plan.fs, plan.fc, plan.chunks)
    kernels.check(status, name)
    kernels.LAUNCHES[name] += 1
    return g, p


def adjacency_backward(e: torch.Tensor, p: torch.Tensor,
                       dg: torch.Tensor) -> torch.Tensor:
    """de (the layout of e) from the forward's e and P and dG."""
    name = "agcn_adjacency_backward"
    kernels.refuse_grad(name, e, p, dg)
    if e.device.type == "cpu":
        return adjacency_backward_reference(e, p, dg)
    n, v, t, _ = e.shape
    k = p.shape[1]
    d = embedding_width(e, k)
    plan = adjacency_plan(n, v, t, k, d)
    _check_cuda(name, e, e.shape, "e")
    for what, x in (("P", p), ("dG", dg)):
        _check_cuda(name, x, (n, k, v, v), what)
    e = _aligned(e)
    de = torch.empty_like(e)
    status = kernels.launch(
        "adaptive", "agcn_adjacency_backward", e, e.data_ptr(), p.data_ptr(),
        dg.data_ptr(), de.data_ptr(), n, v, t, k, d, plan.vp, plan.fs,
        plan.fc, plan.chunks)
    kernels.check(status, name)
    kernels.LAUNCHES[name] += 1
    return de


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class AdjacencyFunction(torch.autograd.Function):
    """G from (e, A, PA): forward ``adjacency_forward``, backward
    ``adjacency_backward`` for de and sum_n dG for dPA; A gets none."""

    @staticmethod
    def forward(ctx, e, a, pa, k):
        if e.is_cuda:
            e = e.contiguous()
        with trace.span("agcn.adjacency"):
            g, p = adjacency_forward(e, a, pa, k)
        ctx.save_for_backward(e, p)
        return g

    @staticmethod
    def backward(ctx, dg):
        e, p = ctx.saved_tensors
        want_e, _, want_pa = ctx.needs_input_grad[:3]
        with trace.span("agcn.adjacency_grad"):
            dg = dg.contiguous()
            de = adjacency_backward(e, p, dg) if want_e else None
            dpa = dg.sum(0) if want_pa else None
        return de, None, dpa, None


def agcn_adjacency(e: torch.Tensor, a: torch.Tensor, pa: torch.Tensor,
                   k: int) -> torch.Tensor:
    """G (N', K, V, V) of embeddings e (N', V, T, 2*K*d), the fixed
    adjacency A and the learned PA (K, V, V)."""
    return AdjacencyFunction.apply(e, a, pa, k)
