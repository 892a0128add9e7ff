"""Which tensors of one full-width ``configs/mediapipe/train_joint.yaml``
step (fp32, 64 clips x T=300) repeat their bits from run to run on the
card, with and without ``remat``, with ``cudnn.deterministic`` off and on:

    python3 scripts/step_repeatability.py [--seed N]

Each setting runs the step four times from the same seeded state and
batch (without remat twice, then with it twice, through ``chip_smoke``'s
``remat_step``) and prints, per run, the loss, the peak memory, the step
time and every parameter, buffer and momentum buffer after SGD that
differs from the first run, with its largest gap; then the card's name
and power limit.  Phase 21 of ``chip_smoke.py`` names the weights whose
gradient this shows not to repeat (``NONREPEATING``)."""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from shift_gcn_torch import kernels
    from shift_gcn_torch.models.shift_gcn import config_from_reference_args
    from shift_gcn_torch.train.config import load_config

    if not torch.cuda.is_available():
        cs.fail("CUDA is not available: this script runs only on a GPU")
    kernels.build_all()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = load_config(["--config", cs.TRAIN_CONFIG])
    config = config_from_reference_args(base.model_args)
    data, labels = cs.synthetic_batch(np.random.default_rng(args.seed),
                                      cs.N_WINDOWS, cs.T_WINDOW)
    batch = {"data": torch.from_numpy(data).to(dev),
             "label": torch.from_numpy(labels).to(dev)}
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        runs = [(remat, *cs.remat_step(
            dataclasses.replace(config, remat=remat), batch, base.base_lr,
            dev, args.seed)) for remat in (False, False, True, True)]
        first = runs[0][2]
        for i, (remat, loss, after, _, peak, ms) in enumerate(runs):
            differ = {k: float((after[k].double() - v.double()).abs().max())
                      for k, v in first.items()
                      if not torch.equal(after[k], v)}
            print(f"cudnn.deterministic={deterministic} run {i} "
                  f"remat={remat}: loss {float(loss)!r}, peak {peak:.3f} "
                  f"GiB, step {ms:.2f} ms; differing from run 0: "
                  f"{sorted(differ.items(), key=lambda kv: -kv[1])}")
    print(cs.card_line())


if __name__ == "__main__":
    main()
