"""The FLOP and byte counters against hand counts at tiny shapes."""

import json
from collections import Counter
from pathlib import Path

import pytest

from benchmark import costs

ROOT = Path(__file__).resolve().parents[2]
TINY = {"model_args": {"num_class": 3, "num_point": 2, "num_person": 1},
        "frames": 4, "in_channels": 3,
        "backbone": [[3, 4, 1, False], [4, 8, 2, True]]}


def test_forward_macs_by_hand():
    # unit 1, T 4, 2 rows a frame: spatial 2*4*3*4, down the same,
    # temporal 2*4*4*4; unit 2: spatial 2*4*4*8, down the same, temporal
    # 2*4*8*8, residual at T'=2 2*2*4*8; classifier 8*3
    unit1 = 96 + 96 + 128
    unit2 = 256 + 256 + 512 + 128
    assert costs.forward_macs(TINY) == unit1 + unit2 + 24
    assert costs.step_flops_per_clip(TINY) == 6 * (unit1 + unit2 + 24)
    assert costs.forward_flops_per_clip(TINY) == 2 * (unit1 + unit2 + 24)


def test_person_count_scales_the_rows():
    two = json.loads(json.dumps(TINY))
    two["model_args"]["num_person"] = 2
    classifier = 24
    assert costs.forward_macs(two) - classifier == \
        2 * (costs.forward_macs(TINY) - classifier)


def test_ops_by_hand():
    ops = costs.ops(TINY, clips=1, itemsize=2, training=True)
    assert Counter(op[0] for op in ops) == {"K1": 4, "K23": 4, "K4": 2, "K5": 2,
                                    "K6": 2}
    # unit 1, first shift: x = y = 1*4*2*4 elements; bytes of x and y in
    # bf16 and ypos in fp32; 3 flops an output
    assert ops[0] == ("K1", 64 * 2 + 16, 96.0)
    # its backward reads x and g and writes dx; 6 flops an input element
    assert ops[1] == ("K23", 96 * 2 + 32, 192.0)
    # K4 of unit 1: x (4*2*3) and out (4*2*4) in bf16, gate, W, bias fp32
    assert ops[4] == ("K4", 56 * 2 + 22 * 4, 192.0)
    assert ops[5] == ("K5", 56 * 2 + 22 * 4, 192.0)
    # K6 also writes dgate and dW
    assert ops[6] == ("K6", 56 * 2 + 40 * 4, 192.0)
    # unit 2's strided shift writes half the frames
    stride2 = [op for op in ops if op[0] == "K1"][3]
    assert stride2 == ("K1", (64 + 32) * 2 + 32, 96.0)
    forward = costs.ops(TINY, clips=1, itemsize=4, training=False)
    assert Counter(op[0] for op in forward) == {"K1": 4, "K4": 2}


def test_bound_takes_the_larger_time_per_op():
    peaks = {"hbm_bytes_per_s": 100.0,
             "flops_per_s": {"bfloat16": 1000.0, "tf32": 10.0,
                             "float32": 1.0}}
    ops = [("A", 200.0, 100.0), ("B", 100.0, 5000.0)]
    # bf16: A 2.0 (bytes) + B 5.0 (flops); fp32 inputs take the TF32 rate
    assert costs.bound_s(ops, peaks, "bfloat16") == pytest.approx(7.0)
    assert costs.bound_s(ops, peaks, "float32") == pytest.approx(10.0 + 500.0)
    assert costs.mfu_pct(50.0, peaks, "bfloat16") == pytest.approx(5.0)


def test_published_peaks():
    table = json.loads((ROOT / "benchmark" / "peaks.json").read_text())
    h100 = table["H100"]
    assert h100["hbm_bytes_per_s"] == 3.35e12
    assert h100["flops_per_s"] == {"bfloat16": 989e12, "tf32": 495e12,
                                   "float32": 67e12}


def test_fall_config_counts():
    config = json.loads((ROOT / "benchmark" / "configs"
                         / "mediapipe_fall.json").read_text())
    # 2.356 G multiply-adds a clip's forward at V=33, T=300
    assert costs.forward_macs(config) == pytest.approx(2.3557e9, rel=1e-4)
