"""Control flow of chip_smoke.py's lowering-knob phase (15), rehearsed on
the CPU on the full-width model: the kernels' plain versions run in
place of the kernels, so every check but the launch counts must pass,
and the launch counts must fail (the plain versions launch nothing)."""

import numpy as np
import torch

import chip_smoke
from shift_gcn_torch.models.shift_gcn import config_from_reference_args
from torch_chip_smoke_helpers import (  # noqa: F401 (fixtures)
    rehearsal, training_rehearsal)

FULL_ARGS = {"num_class": 2, "num_point": 33, "num_person": 1,
             "graph": "mediapipe_pose"}


def test_lowering_knob_phase_rehearses_on_cpu(training_rehearsal, capsys,
                                              tmp_path):
    """Phase 15 on the full-width MediaPipe model at T=40 and 4 clips."""
    config = config_from_reference_args(FULL_ARGS)
    out = chip_smoke.run_lowering_knobs(
        config, np.random.default_rng(0), torch.device("cpu"),
        str(tmp_path), 0, "card")
    # six eval forwards and four steps: only their launch counts fail
    assert len(training_rehearsal) == 10, training_rehearsal
    assert all("launch counts" in msg for msg in training_rehearsal)
    # the plain path against itself: no gap at all
    assert out["xpos_fwd"] == out["far_fwd"] == out["far_fwd16"] == 0.0
    assert out["xpos_step"] == out["far_step"] == 0.0
    for label in ("bn_lp", "bn_lp_eval off", "fp32 + compute_dtype bf16"):
        loss_gap, cos, rel, agree, fwd = out[label]
        assert loss_gap == rel == fwd == 0.0 and agree == 1.0
    printed = capsys.readouterr().out
    assert printed.count("[knobs]") == 4
    assert printed.count("[step] exact_xpos fp32") == 1
    assert "|ypos| 12 loads under 16, refused under 8" in printed
