"""The readings that a 2s-AGCN cell's limits are set from, on the card:
``benchmark.control``'s, with four faults planted in the port's ``agcn2s``
model beside the two it plants in every training cell.

    python -m benchmark.control_agcn --workload agcn_ntu60_train_b64 \\
        --seeds <n> [<n> ...]

The faults: the attention's softmax over target joints instead of source
joints (``target_softmax``), the temperature 1/T instead of 1/(d*T)
(``temperature_t``), PA left out of the graph (``no_pa``), and the GCN's
inner residual (``down(x)``, or x) left out (``no_inner_residual``).  Each
keeps every parameter in the graph (times zero where it is left out), so
that the optimizer holds a gradient for every leaf.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import sys

import torch

from benchmark import control


def _adjacency(make):
    from shift_gcn_torch.ops import adaptive

    return control.patched(adaptive, "agcn_adjacency", make)


def target_softmax():
    """The attention normalized over target joints (plain PyTorch)."""

    def make(op):
        def attention(e, a, pa, k):
            n, v, t, q = e.shape
            d = q // (2 * k)
            emb = e.reshape(n, v, t, 2, k, d)
            s = torch.einsum("nvtkc,nutkc->nkvu", emb[:, :, :, 0],
                             emb[:, :, :, 1]) / (d * t)
            return torch.softmax(s, dim=3) + (a + pa)
        return attention
    return _adjacency(make)


def temperature_t():
    """The logits divided by T alone: the a_k scaled by d."""

    def make(op):
        def attention(e, a, pa, k):
            d = e.shape[-1] // (2 * k)
            return op(torch.cat([e[..., :k * d] * d, e[..., k * d:]], -1),
                      a, pa, k)
        return attention
    return _adjacency(make)


def no_pa():
    return _adjacency(lambda op: (lambda e, a, pa, k: op(e, a, pa * 0, k)))


def no_inner_residual():
    from shift_gcn_torch.models import agcn

    return control.patched(agcn.UnitGCN, "inner_residual", lambda inner: (
        lambda self, x: inner(self, x) * 0))


FAULTS = {"target_softmax": target_softmax, "temperature_t": temperature_t,
          "no_pa": no_pa, "no_inner_residual": no_inner_residual}


def main(argv=None) -> int:
    control.TRAIN_FAULTS.update(FAULTS)
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
