"""A two-minute check of K4, K5, K6, K1 and the fused K2+K3 past the
144-row frame tile, on the card.

    python3 scripts/wide_kernels_quick.py

Builds the kernels, then runs K4, K5 and K6 at V = 33, 144, 145, 160,
256 and 543 on six (R, C, D, d0) cases (unit 1's C=3, a 64 -> 128 layer,
a tensor-parallel slice at d0 = 256, the 256-wide layer, an odd C=130,
D=70 at d0 = 5, d0 = 64) in fp32 and bf16 against their plain versions
(max |err| of scale: 2e-5, 2^-7 in bf16; K6 2e-5 and bit-equal across
two launches), K1 bit-equal and the fused K2+K3's errors at V = 145 and
543 with ypos U(-7, 7), then times K4, K5, K6 and the plain K4 once at
V=33 (64 clips x T=300) and V=543 (8 clips) on a 64 -> 128 layer.
Exits non-zero if a check fails.  ``chip_smoke.py`` phase 22 is the
full check; this is the quick one for kernel work."""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from shift_gcn_torch import kernels  # noqa: E402
from shift_gcn_torch.ops import shift_gcn_kernel as sk  # noqa: E402
from shift_gcn_torch.ops import spatial_shift as ss  # noqa: E402
from shift_gcn_torch.ops import temporal_shift as ts  # noqa: E402

CASES = ((600, 3, 64, 0), (600, 64, 128, 0), (300, 128, 256, 256),
         (150, 256, 256, 0), (300, 130, 70, 5), (300, 64, 64, 64))


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) / max(
        1.0, float(b.float().abs().max()))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script runs only on a GPU")
    t0 = time.time()
    kernels.build_all()
    print(f"build {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for v in (33, 144, 145, 160, 256, 543):
        for dtype in (torch.float32, torch.bfloat16):
            tol = 2e-5 if dtype == torch.float32 else 2 ** -7
            for r, c, d, d0 in CASES:
                x = torch.randn(r, v, c, generator=gen, device=dev).to(dtype)
                g = torch.randn(r, v, d, generator=gen, device=dev).to(dtype)
                gate = torch.tanh(torch.randn(v, c, generator=gen,
                                              device=dev)) + 1
                w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
                b = torch.randn(d, generator=gen, device=dev) * 0.1
                e4 = rel_err(sk.shift_gcn_forward(x, gate, w, b, d0),
                             ss.shift_gcn_transform(x, gate, w, b, d0))
                e5 = rel_err(sk.shift_gcn_dx(g, gate, w, d0),
                             ss.shift_gcn_dx_reference(g, gate, w, d0))
                got = sk.shift_gcn_wgrad(x, g, gate, w, d0)
                again = sk.shift_gcn_wgrad(x, g, gate, w, d0)
                want = ss.shift_gcn_wgrad_reference(x, g, gate, w, d0)
                e6 = max(rel_err(a, ref) for a, ref in zip(got, want))
                same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
                ok = e4 <= tol and e5 <= tol and e6 <= 2e-5 and same
                bad += not ok
                print(f"V={v} {str(dtype)[6:]} R={r} C={c} D={d} d0={d0}: "
                      f"K4 {e4:.3g} K5 {e5:.3g} K6 {e6:.3g} repeat {same} "
                      f"{'OK' if ok else 'FAIL'}", flush=True)
    for v in (145, 543):
        for dtype in (torch.float32, torch.bfloat16):
            for t, c, s in ((300, 64, 1), (300, 128, 2), (75, 256, 1),
                            (75, 130, 2)):
                x = torch.randn(4, t, v, c, generator=gen,
                                device=dev).to(dtype)
                g = torch.randn(4, t // s, v, c, generator=gen,
                                device=dev).to(dtype)
                y = torch.rand(c, generator=gen, device=dev) * 14 - 7
                k1 = torch.equal(ts.temporal_shift(x, y, s),
                                 ts.temporal_shift_reference(x, y, s))
                dx, raw = ts.temporal_shift_backward(x, g, y, s)
                want_dx, want_raw = ts.temporal_shift_backward_reference(
                    x, g, y, s)
                bad += not k1
                print(f"K1 V={v} {str(dtype)[6:]} T={t} C={c} s={s}: "
                      f"bit-equal {k1}, K2+K3 dx {rel_err(dx, want_dx):.3g}"
                      f", gy_raw {rel_err(raw, want_raw):.3g}", flush=True)
    for v, r in ((33, 64 * 300), (543, 8 * 300)):
        x = torch.randn(r, v, 64, generator=gen, device=dev)
        gate = torch.tanh(torch.randn(v, 64, generator=gen, device=dev)) + 1
        w = torch.randn(64, 128, generator=gen, device=dev)
        b = torch.zeros(128, device=dev)
        g = torch.randn(r, v, 128, generator=gen, device=dev)
        for name, fn in (
                ("K4", lambda: sk.shift_gcn_forward(x, gate, w, b)),
                ("K5", lambda: sk.shift_gcn_dx(g, gate, w)),
                ("K6", lambda: sk.shift_gcn_wgrad(x, g, gate, w)),
                ("K4 plain", lambda: ss.shift_gcn_transform(x, gate, w, b))):
            fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                fn()
            end.record()
            end.synchronize()
            print(f"time V={v} R={r} C=64 D=128 {name}: "
                  f"{start.elapsed_time(end) / 10:.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("failed checks:", bad)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
