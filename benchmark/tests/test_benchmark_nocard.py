"""A run fails without a card, and in a checkout that holds only the
benchmark's own files."""

import json
import os
import subprocess
import sys
from pathlib import Path

from benchmark.tests import toy

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_exits_non_zero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "fall_train_b64", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "CUDA" in out.stderr


def test_without_the_program_a_run_fails(tmp_path):
    """Past the card check, a directory with only BENCHMARK.json and the
    benchmark cannot import the program."""
    root = toy.make(tmp_path / "bare", port=False)
    script = (
        "import sys, torch; sys.path.insert(0, sys.argv[1]);"
        "from benchmark import manifest, run;"
        "cell = manifest.cell('fall_train_b64', sys.argv[1]);"
        "run.run_cell(cell, 1, 1.0, False, torch.device('cpu'))")
    out = subprocess.run([sys.executable, "-c", script, str(root)],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "shift_gcn_torch" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_the_command_is_what_the_manifest_says():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert manifest["command"][1:] == ["-m", "benchmark.run"]
