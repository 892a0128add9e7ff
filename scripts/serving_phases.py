"""Phases 11-13 of ``chip_smoke.py`` (live serving: the registered ops at
batch 1, the streaming detector, the two ``.pt2`` artifact flavours) in
the checkout at CHECKOUT, on the card, for an A/B comparison of two
checkouts inside one call:

    python3 scripts/serving_phases.py <checkout> [--seed N]

Imports CHECKOUT's ``chip_smoke`` and ``shift_gcn_torch`` (its kernels
built into its own ``_build/``), runs its phases 11-13 from the seed and
prints one line: the streaming push -> update median and p90 at hop 30
(host clock) and each artifact's ms a batch beside the live module's,
with the card's name and power limit.  Run it once per checkout and
process, in turns (parent, change, change, parent)."""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkout")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = Path(args.checkout).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    import chip_smoke
    from shift_gcn_torch import kernels
    from shift_gcn_torch.inference import pipeline
    from shift_gcn_torch.models.shift_gcn import ModelConfig
    from shift_gcn_torch.utils.checkpoint import state_dict_from_arrays

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script runs only on a GPU")
    if not chip_smoke.__file__.startswith(str(root)):
        sys.exit(f"imported {chip_smoke.__file__}, not {root}'s")
    kernels.build_all()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    card = chip_smoke.card_line()
    config = ModelConfig(num_class=2, num_point=chip_smoke.V, num_person=1,
                         graph="mediapipe_pose")
    chip_smoke.check_stream_shapes(config, gen, rng, dev)
    dicts = {m: state_dict_from_arrays(*chip_smoke.random_arrays(config,
                                                                 rng))
             for m in pipeline.MODALITY_ORDER}
    p50, p90 = chip_smoke.check_streaming(
        pipeline.EnsemblePredictor(dicts, model_config=config), rng, card)
    ms = chip_smoke.check_artifacts(dicts["joint"], config, rng, dev, card)
    print(f"[serving-ab] {root.name}: stream p50/p90 {p50:.4f}/{p90:.4f} "
          f"ms; pt2 inputs {ms['inputs'][0]:.4f}, baked "
          f"{ms['baked'][0]:.4f}, live {ms['inputs'][1]:.4f} / "
          f"{ms['baked'][1]:.4f} ms a batch | {card}")


if __name__ == "__main__":
    main()
