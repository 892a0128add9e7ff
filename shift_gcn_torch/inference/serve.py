"""Batch scoring from an exported artifact (``inference/export.py``).

Reads a ``.npy`` of pre-normalized clips in the feeder layout
``(N, C, T, V, M)``, scores them through the artifact in fixed-size
batches (the artifact's exported batch size; the tail is zero-padded and
stripped), and writes the logits as ``.npy``.  Baked artifacts are
self-contained; weights-as-inputs artifacts take a ``--weights``
checkpoint (a ``.pt`` or a run dir), restored with the artifact's own
inputs as the template.  The artifact runs on the device it was exported
for, CUDA by default; it is never moved to another.

    python -m shift_gcn_torch.inference.serve --artifact model.pt2 \
        --data val_data_joint.npy --out scores.npy --batch-size 64
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from shift_gcn_torch.inference.export import (
    Weights, artifact_is_baked, check_artifact_device, load_exported,
    restore_weights_for_artifact, weight_specs)
from shift_gcn_torch.models.shift_gcn import check_shift_range
from shift_gcn_torch.ops.temporal_shift import DEFAULT_MAX_SHIFT
from shift_gcn_torch.utils.device import resolve_device


def score_clips(artifact, data: np.ndarray, batch_size: int,
                weights: Optional[Weights] = None,
                device="cuda",
                max_shift: int = DEFAULT_MAX_SHIFT) -> np.ndarray:
    """Run (N, C, T, V, M) clips through the artifact in fixed batches.

    ``weights``: a state_dict for the weights-as-inputs flavour (checked
    for the shift range at ``max_shift``, the model's lowering's, as
    ``load_state_dict`` would); None for baked artifacts.  ``device`` must
    be the artifact's."""
    device = resolve_device(device)
    check_artifact_device(artifact, device)
    if (weights is None) != artifact_is_baked(artifact):
        raise ValueError("a baked artifact takes no weights; a "
                         "weights-as-inputs artifact needs them")
    if weights is not None:
        check_shift_range(weights.items(), max_shift)
        weights = {name: weights[name].to(device)
                   for name in weight_specs(artifact)}
    call = artifact.module()
    n = data.shape[0]
    outs = []
    with torch.inference_mode():
        for start in range(0, n, batch_size):
            chunk = np.array(data[start:start + batch_size], np.float32)
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            x = torch.from_numpy(chunk).to(device)
            out = call(weights, x) if weights is not None else call(x)
            outs.append(out.cpu().numpy()[:batch_size - pad])
    return np.concatenate(outs) if outs else np.zeros((0,))


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="score clips with an exported artifact (.pt2)")
    parser.add_argument("--artifact", required=True)
    parser.add_argument("--data", required=True,
                        help=".npy of (N, C, T, V, M) pre-normalized clips")
    parser.add_argument("--out", required=True, help="output scores .npy")
    parser.add_argument("--batch-size", type=int, default=64,
                        help="must match the artifact's exported batch size")
    parser.add_argument("--weights", default=None,
                        help="checkpoint (.pt or run dir) for "
                        "weights-as-inputs artifacts")
    parser.add_argument("--device", default="cuda",
                        help="the artifact's device (default cuda)")
    parser.add_argument("--max-shift", type=int, default=DEFAULT_MAX_SHIFT,
                        help="the model's tap radius (lowering.max_shift), "
                        "for the weights' shift range check")
    args = parser.parse_args(argv)

    artifact = load_exported(args.artifact)
    weights = None
    if not artifact_is_baked(artifact):
        if args.weights is None:
            raise SystemExit(
                "this artifact takes weights as inputs (exported with "
                "--no-baked); pass --weights <checkpoint>")
        weights = restore_weights_for_artifact(args.weights, artifact,
                                               args.max_shift)
    data = np.load(args.data, mmap_mode="r")
    scores = score_clips(artifact, data, args.batch_size, weights=weights,
                         device=args.device, max_shift=args.max_shift)
    np.save(args.out, scores)
    print(json.dumps({"clips": int(scores.shape[0]),
                      "classes": int(scores.shape[-1]),
                      "out": args.out}))


if __name__ == "__main__":
    main()
