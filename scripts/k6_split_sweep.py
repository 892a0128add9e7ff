"""K6 (``shift_gcn_wgrad``) over splits of the frames, on the card.

    python3 scripts/k6_split_sweep.py

For each launch shape (T, C, D) of one train step of the default
backbone with 8 clips, at V = 543, 256 and 145, fp32 and bf16, launches
K6 with the split the wrapper picks (``wgrad_split``) and with chunks of
1200, 608, 304, 160, 96 and 48 frames (each a fixed summation order, so
every split is deterministic), checks each against the plain version
(max |err| of scale) and prints each one's time by CUDA events, then
the step's total per chunk.  The card's name and power limit end the
output."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from shift_gcn_torch import kernels  # noqa: E402
from shift_gcn_torch.models.shift_gcn import ModelConfig  # noqa: E402
from shift_gcn_torch.ops import shift_gcn_kernel as sk  # noqa: E402
from shift_gcn_torch.ops import spatial_shift as ss  # noqa: E402

CHUNKS = (1200, 608, 304, 160, 96, 48)
CLIPS = 8


def launch(lib, x, g, gate, w, parts, chunk):
    r, v, c = x.shape
    d = w.shape[1]
    scratch = lib.shift_gcn_wgrad_scratch(r, v, c, d, 0, parts, chunk)
    partial = torch.empty(scratch, dtype=torch.float32, device=x.device)
    out = (torch.empty((v, c), device=x.device),
           torch.empty((c, d), device=x.device),
           torch.empty(d, device=x.device))
    status = kernels.launch(
        "shift_gcn", "shift_gcn_wgrad", x, x.data_ptr(), g.data_ptr(),
        gate.data_ptr(), w.data_ptr(), partial.data_ptr(), scratch,
        *(t.data_ptr() for t in out), r, v, c, d, 0, parts, chunk,
        int(x.dtype == torch.bfloat16))
    kernels.check(status, "shift_gcn_wgrad")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script runs only on a GPU")
    lib = kernels.library("shift_gcn")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = chip_smoke.forward_shapes(ModelConfig(num_class=2), 300)[1]
    for v in (543, 256, 145):
        totals = {}
        groups = -(-v // sk.WGRAD_GROUP)
        for t, c, d in sorted(set(shapes)):
            count = shapes.count((t, c, d))
            r = CLIPS * t
            chosen = sk.wgrad_split(r, v, c, d)
            tiles = groups * -(-c // 32) * -(-d // 32)
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(r, v, c, generator=gen, device=dev).to(dtype)
                g = torch.randn(r, v, d, generator=gen, device=dev).to(dtype)
                gate = torch.tanh(torch.randn(v, c, generator=gen,
                                              device=dev)) + 1
                w = torch.randn(c, d, generator=gen, device=dev)
                want = ss.shift_gcn_wgrad_reference(x, g, gate, w)
                line = []
                for chunk in (chosen[1],) + CHUNKS:
                    parts = -(-r // chunk)
                    label = "wgrad_split" if chunk == chosen[1] and not \
                        line else chunk
                    got = launch(lib, x, g, gate, w, parts, chunk)
                    err = max(float((a - b).abs().max())
                              / max(1.0, float(b.abs().max()))
                              for a, b in zip(got, want))
                    ms = chip_smoke.time_ms(
                        lambda: launch(lib, x, g, gate, w, parts, chunk),
                        iters=5, reps=3)
                    line.append(f"{label} ({parts} x {chunk}, "
                                f"{parts * tiles} blocks) {ms:.4f} ms, "
                                f"err {err:.2g}")
                    key = (str(dtype)[6:], label)
                    totals[key] = totals.get(key, 0.0) + count * ms
                print(f"[k6] V={v} {str(dtype)[6:]} R={r} C={c} D={d} "
                      f"x{count}: " + "; ".join(line), flush=True)
        print(f"[k6] V={v} a step's launches, ms by chunk: "
              + ", ".join(f"{k[0]} {k[1]} {ms:.3f}"
                          for k, ms in sorted(totals.items(), key=str)))
    print(chip_smoke.card_line())


if __name__ == "__main__":
    main()
