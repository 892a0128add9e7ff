"""Run one cell of ``BENCHMARK.json`` on the cards of this machine.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (the inputs and weights from the seed, the program's objects,
the warm-up that runs every shape the cell's traffic uses) is timed as
``setup_s``, from the start of the process to the first timed step or
report.  The window then runs the cell's traffic for ``--seconds``.
``--trace 1`` runs the same window and then profiles a short steady
sub-window for the per-layer metrics.  Once the window has closed and
the program's state is freed, what the timed path produced is compared
with the plain reference (``checks.py``, ``reference/``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number beside its
limit (also the last lines of standard error).  With no CUDA card, too
few of them, or JAX loaded once the window has closed, it exits with 2
and prints no result.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

# one host thread for the math libraries, set before they load: the
# run's host work (pre-normalization, the feeder) is one process whose
# pools would only contend with its own dispatch thread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import torch  # noqa: E402

from benchmark import card, manifest, result  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: torch.device):
    """The cell's driver, ``drivers/<the mix's driver>.py``, on
    ``device``: (Outcome, device facts).  The caller has checked the
    cards."""
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    workdir = Path(tempfile.mkdtemp(prefix=f"benchmark-{cell.name}-"))
    try:
        outcome = driver.run(cell, seed, seconds, trace, device, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return outcome, card.device_facts(device, outcome.count)


def main(argv=None) -> int:
    args = parse(argv)
    cell = manifest.cell(args.workload)
    try:
        card.require_cards(cell.chips)
    except card.NoCard as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return 2
    card.configure_environment()
    # the first run in a checkout builds here; the rest of set-up is the
    # same in every run
    print(f"set-up: the port's kernels built or found in "
          f"{card.build_kernels():.3f} s", file=sys.stderr)
    outcome, device = run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda"))
    loaded = card.forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {loaded}; nothing it runs may "
              "import JAX or the JAX package", file=sys.stderr)
        return 2
    for prof in outcome.layer.get("profiles") or []:
        if prof:
            print(f"profiler: window {prof['window_s']:.6f} s with device "
                  f"activity alone, busy {prof['busy_s']:.6f} s; host "
                  f"events add {prof['host_cost_s']:.6f} s", file=sys.stderr)
    line = result.build(cell, outcome, bool(args.trace), device)
    result.report_checks(line, outcome.numbers)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
