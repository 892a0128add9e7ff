"""Work counted from the model's shapes: FLOPs for MFU, and the bound of
each port-kernel op for its roofline share.  What a model's work is, is
its family's (``families/<family>.py``: ``forward_macs`` and ``ops``).

MFU counts multiply-adds (2 FLOPs each) as the family does; a training
step counts them three times and nothing recomputed.

An op's bound is the larger of its bytes over the HBM rate (each input
read once, each output written once) and its FLOPs over the highest
published rate its input type allows (bf16: the bf16 tensor-core rate;
fp32: TF32).  The ops are the work of a step, whatever kernels do it;
Shift-GCN's are K1 (temporal shift forward), K23 (its backward: input
gradient and position gradient), K4 (spatial forward), K5 (its input
gradient), K6 (its weight gradients).
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark import families

Op = Tuple[str, float, float]   # (op, bytes, flops)


def forward_macs(config: dict) -> float:
    """Multiply-adds of one clip's forward pass."""
    return families.of(config).forward_macs(config)


def step_flops_per_clip(config: dict) -> float:
    return 3 * 2 * forward_macs(config)


def forward_flops_per_clip(config: dict) -> float:
    return 2 * forward_macs(config)


def ops(config: dict, clips: int, itemsize: int, training: bool
        ) -> List[Op]:
    """(op, bytes, flops) of every port-kernel op of one forward
    (``training`` False) or one training step of ``clips`` clips; empty
    for a family that runs none."""
    return families.of(config).ops(config, clips, itemsize, training)


def bound_s(ops_list: List[Op], peaks: dict, input_dtype: str) -> float:
    """The least time of the ops: per op, the larger of bytes over the
    HBM rate and FLOPs over the input type's highest rate."""
    rate = peaks["flops_per_s"]["bfloat16" if input_dtype == "bfloat16"
                                else "tf32"]
    hbm = peaks["hbm_bytes_per_s"]
    return sum(max(b / hbm, f / rate) for _, b, f in ops_list)


def mfu_pct(flops_per_s: float, peaks: dict, dtype: str) -> float:
    return 100.0 * flops_per_s / peaks["flops_per_s"][dtype]

