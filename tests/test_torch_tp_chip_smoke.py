"""Control flow of chip_smoke.py's tensor-parallel phase (19), rehearsed
on the CPU: full width at 4 clips of T=64, the kernels' plain versions in
place of the kernels, so every check but the launch counts must pass
(the kernels at every rank's (shape, d0), the [1, 2] Trainer run and its
checkpoint evaluated in one process, each rank's fp32 step against the
one-process step, both planted faults caught), and the launch counts
must fail (the plain versions launch nothing)."""

import numpy as np
import torch

import chip_smoke
from test_torch_chip_smoke import rehearsal, training_rehearsal  # noqa: F401


def test_tp_phase_rehearses_on_cpu(training_rehearsal,  # noqa: F811
                                   monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(chip_smoke, "T_WINDOW", 64)
    out = chip_smoke.run_tensor_parallel(
        np.random.default_rng(0), torch.device("cpu"), str(tmp_path),
        "card", 0)
    # 19b's two ranks and 19c's four: their launch counts
    assert len(training_rehearsal) == 6, training_rehearsal
    assert all("launch" in msg for msg in training_rehearsal)
    assert len(out["tp12_ms"]) == 2 and len(out["tp22_ms"]) == 4
    printed = capsys.readouterr().out
    # 10 units' (shape, d0) launches: 6 shapes x 2 ranks x 2 dtypes, at
    # each of the two meshes
    assert "at 48 (shape, d0) launches" in printed
    assert "at mesh [1, 2], 2 gloo ranks sharing this card" in printed
    assert "(full layout) evaluated in one process" in printed
    # the sound steps of 19b's 2 ranks and 19c's 4, and the worst rank of
    # the sharded_sum fault, which moves no ypos step
    assert printed.count("ypos steps equal on 2816 of 2816, 0 flips at a "
                         "tie, 0 off one") == 7
    for fault in chip_smoke.TP_FAULTS:
        assert f"planted fault {fault}: caught on ranks" in printed
