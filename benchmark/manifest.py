"""The benchmark's manifest, ``BENCHMARK.json``, and the files it names.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by the name the manifest
gives it:

- a configuration: the ``file`` of its ``configs`` entry (JSON);
- a model family: ``families/<family>.py``, the family that a
  configuration's ``"family"`` key names (``shift_gcn`` without one):
  its weights, work counts and plain reference (``families/__init__.py``);
- a traffic mix: ``traffic/<traffic>.json``, parameters for the general
  driver its ``driver`` key names (``drivers/<driver>.py``);
- a per-layer metric: ``metrics/<name>.py``, a reader with ``read(ctx)``
  that returns a number or None (nothing to read);
- a cell's correctness limits: ``limits/<workload>.json``.

A new configuration, family, mix, metric or cell is a new file and a new
entry; no file here changes.  A cell whose configuration names a family
with no file is refused when it is loaded.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

from benchmark import families

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_manifest(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    root: Path


def metrics_of(manifest: dict, workload: str) -> (List[dict], List[dict]):
    """(end-to-end metrics, per-layer metrics) that ``workload`` reports:
    those that list it under ``workloads``, and those without the key
    (an end-to-end one in every cell, a per-layer one wherever its
    ``moves`` is reported)."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def cell(workload: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    manifest = load_manifest(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"workload {workload!r} is not in BENCHMARK.json; "
                       f"known: {[w['name'] for w in manifest['workloads']]}")
    config_entry = next(c for c in manifest["configs"]
                        if c["name"] == entry["config"])
    config = _load_json(root / config_entry["file"])
    families.check(config, root / "benchmark" / "families")
    traffic = _load_json(root / "benchmark" / "traffic"
                         / f"{entry['traffic']}.json")
    e2e, layer = metrics_of(manifest, workload)
    limits_path = root / "benchmark" / "limits" / f"{workload}.json"
    limits = (_load_json(limits_path)["limits"] if limits_path.exists()
              else {})
    return Cell(workload, int(entry["chips"]), config, entry["traffic"],
                traffic, e2e, layer, limits, root)


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def kernel_names(root: Path = ROOT) -> Dict[str, List[str]]:
    """Kernel-name patterns by group, the union of every file under
    ``metrics/kernel_names/``: a later PR that renames or fuses a kernel
    adds a file."""
    groups: Dict[str, List[str]] = {}
    for path in sorted((Path(root) / "benchmark" / "metrics"
                        / "kernel_names").glob("*.json")):
        for group, patterns in _load_json(path).items():
            groups.setdefault(group, []).extend(patterns)
    return groups


def peaks(kind: str, root: Path = ROOT) -> Optional[dict]:
    """The published peaks of the card whose name contains a key of
    ``peaks.json``, or None."""
    table = _load_json(Path(root) / "benchmark" / "peaks.json")
    for key, row in table.items():
        if key in kind:
            return row
    return None
