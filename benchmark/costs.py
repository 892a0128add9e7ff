"""Work counted from the model's shapes: FLOPs for MFU, and the bound of
each Shift-GCN kernel op for its roofline share.

MFU counts multiply-adds (2 FLOPs each) of the 1x1 convolutions (the
temporal block's linear), the spatial block's feature product, the down
and residual 1x1 convolutions, and the classifier; a training step
counts them three times and nothing recomputed.

An op's bound is the larger of its bytes over the HBM rate (each input
read once, each output written once) and its FLOPs over the highest
published rate its input type allows (bf16: the bf16 tensor-core rate;
fp32: TF32).  The ops are the work of a step, whatever kernels do it:
K1 (temporal shift forward), K23 (its backward: input gradient and
position gradient), K4 (spatial forward), K5 (its input gradient), K6
(its weight gradients).
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark.weights import units

Op = Tuple[str, float, float]   # (op, bytes, flops)


def unit_shapes(config: dict):
    """Per unit: (t_in, t_out, cin, cout, stride, residual kind)."""
    t = config["frames"]
    for _, cin, cout, stride, kind in units(config):
        yield t, t // stride, cin, cout, stride, kind
        t //= stride


def forward_macs(config: dict) -> float:
    """Multiply-adds of one clip's forward pass."""
    args = config["model_args"]
    rows = args["num_point"] * args["num_person"]
    macs = 0.0
    for t_in, t_out, cin, cout, _, kind in unit_shapes(config):
        macs += rows * t_in * cin * cout            # spatial product
        if cin != cout:
            macs += rows * t_in * cin * cout        # down conv
        macs += rows * t_in * cout * cout           # temporal 1x1
        if kind == "conv":
            macs += rows * t_out * cin * cout       # residual conv
    feat = config["backbone"][-1][1]
    return macs + feat * args["num_class"]


def step_flops_per_clip(config: dict) -> float:
    return 3 * 2 * forward_macs(config)


def forward_flops_per_clip(config: dict) -> float:
    return 2 * forward_macs(config)


def ops(config: dict, clips: int, itemsize: int, training: bool
        ) -> List[Op]:
    """(op, bytes, flops) of every Shift-GCN kernel op of one forward
    (``training`` False) or one training step of ``clips`` clips."""
    args = config["model_args"]
    v = args["num_point"]
    n = clips * args["num_person"]
    out: List[Op] = []
    for t_in, t_out, cin, cout, stride, _ in unit_shapes(config):
        r = n * t_in
        for c, s in ((cout, 1), (cout, stride)):
            x = n * t_in * v * c
            y = n * (t_in // s) * v * c
            out.append(("K1", (x + y) * itemsize + c * 4, 3.0 * y))
            if training:
                out.append(("K23", (2 * x + y) * itemsize + 2 * c * 4,
                            6.0 * x))
        params = (v * cin + cin * cout + cout) * 4
        act = (r * v * cin + r * v * cout) * itemsize
        mm = 2.0 * r * v * cin * cout
        out.append(("K4", act + params, mm))
        if training:
            out.append(("K5", act + params, mm))
            out.append(("K6", act + (2 * (v * cin + cin * cout) + cout) * 4,
                        mm))
    return out


def bound_s(ops_list: List[Op], peaks: dict, input_dtype: str) -> float:
    """The least time of the ops: per op, the larger of bytes over the
    HBM rate and FLOPs over the input type's highest rate."""
    rate = peaks["flops_per_s"]["bfloat16" if input_dtype == "bfloat16"
                                else "tf32"]
    hbm = peaks["hbm_bytes_per_s"]
    return sum(max(b / hbm, f / rate) for _, b, f in ops_list)


def mfu_pct(flops_per_s: float, peaks: dict, dtype: str) -> float:
    return 100.0 * flops_per_s / peaks["flops_per_s"][dtype]

