"""A copy of the benchmark at test sizes: every configuration cut to a
4-unit backbone of 16-32 channels at T=24, 32 training clips in batches
of 8, the report pool to 4 tracks of 300-700 frames.  The copy holds
``BENCHMARK.json`` and ``benchmark/`` and links the port, so that files
added to it are found as a later PR's would be."""

import copy
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SMALL = [[3, 16, 1, False], [16, 16, 1, True], [16, 32, 2, True],
         [32, 32, 1, True]]


def small_config(config: dict) -> dict:
    config = copy.deepcopy(config)
    config.update(frames=24, backbone=SMALL, train_clips=32, val_clips=8)
    config["model_args"]["blocks"] = SMALL
    config["train"].update(batch_size=8, test_batch_size=8)
    return config


def make(dest: Path, port: bool = True) -> Path:
    dest = Path(dest)
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy2(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    if port:
        (dest / "shift_gcn_torch").symlink_to(ROOT / "shift_gcn_torch")
    manifest = json.loads((dest / "BENCHMARK.json").read_text())
    for entry in manifest["configs"]:
        path = dest / entry["file"]
        path.write_text(json.dumps(small_config(json.loads(
            path.read_text()))))
    mix = dest / "benchmark" / "traffic" / "report_tracks.json"
    params = json.loads(mix.read_text())
    params.update(pool=4, frames_min=300, frames_max=700,
                  calibration_windows=8, check_reports=2, profile_reports=1)
    mix.write_text(json.dumps(params))
    return dest
