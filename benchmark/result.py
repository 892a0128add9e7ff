"""What a driver hands back, and the run's result line."""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Dict

from benchmark import checks, manifest


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]            # end-to-end metric -> value
    attempted: int
    failed: int
    numbers: dict                    # checks.train_numbers / report_numbers
    memory_peak_bytes: int
    count: int                       # cards used
    layer: dict                      # what the per-layer readers read


def _clean(value):
    return value if isinstance(value, (int, float)) and math.isfinite(
        value) else None


def layer_context(cell, outcome: Outcome, kind: str) -> dict:
    ctx = dict(outcome.layer)
    ctx.update(config=cell.config, mix=cell.traffic, cell=cell.name,
               peaks=manifest.peaks(kind, cell.root),
               kernel_names=manifest.kernel_names(cell.root))
    return ctx


def build(cell, outcome: Outcome, trace: bool, device: dict) -> dict:
    """The result line's object; the checks come last."""
    correct, compared = checks.judge(outcome.numbers, cell.limits)
    if trace:
        ctx = layer_context(cell, outcome, device["kind"])
        metrics = {}
        for spec in cell.per_layer:
            value = manifest.metric_reader(spec["name"], cell.root)(ctx)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        metrics = {spec["name"]: {"value": outcome.e2e[spec["name"]],
                                  "unit": spec["unit"]}
                   for spec in cell.end_to_end}
    dev = {"platform": device["platform"], "kind": device["kind"],
           "count": outcome.count,
           "memory_peak_bytes": int(outcome.memory_peak_bytes),
           "power_limit": device.get("power_limit")}
    line = {"correct": bool(correct), "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics, "device": dev}
    profiles = [p for p in outcome.layer.get("profiles", []) if p]
    if trace and profiles:
        dev["busy_s"] = sum(p["busy_s"] for p in profiles) / len(profiles)
        dev["window_s"] = profiles[0]["window_s"]
        top = sorted(profiles[0]["kernels"].items(), key=lambda kv: -kv[1])
        line["breakdown"] = {"device_ops": [[k, v] for k, v in top[:10]],
                             "idle_gaps": profiles[0]["gaps"][:10]}
    line["checks"] = {name: {"value": _clean(c["value"]),
                             "limit": c["limit"]}
                      for name, c in compared.items()}
    return line


def report_checks(line: dict, numbers: dict,
                  stream=sys.stderr) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    shown = {k: v for k, v in numbers.items() if not k.startswith("_")}
    print(f"numbers: {shown}", file=stream)
    worst = numbers.get("_worst")
    if worst:
        print(f"worst leaves: {worst['grad_gap']} (grad_gap), "
              f"{worst['change_gap']} (change_gap); left out of "
              f"change_gap: {len(worst['left_out'])} leaves", file=stream)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=stream)
    stream.flush()

