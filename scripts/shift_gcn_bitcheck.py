"""K4, K5 and K6 of this checkout against another build of
``csrc/shift_gcn.cu`` (an earlier commit's, with the output-channel
offset ``d0`` in its interface, as tensor parallelism added it), bit
for bit, on the card.

    git show <commit>:shift_gcn_torch/csrc/shift_gcn.cu > _proof/old.cu
    python3 scripts/shift_gcn_bitcheck.py _proof/old.cu \
        [--write-digests scripts/shift_gcn_v144_digests.json]

Builds the other source with the same nvcc flags into ``_proof/``, then
runs both builds on the same seeded inputs, ``chip_smoke.py``'s
``v144_cases``: the whole-frame tiles at V = 25 and 33, every (T, C, D)
of the backbone's units at 4 clips, fp32 and bf16, d0 = 0 and 32; it
fails unless every output is bit-equal.  Then it compares the other
build at d0 = 0 against this checkout's at d0 = 32 on a narrow layer,
where the outputs that read the shear on d must differ (so the
comparison can fail).  ``--write-digests`` writes the other build's
output digests, which ``chip_smoke.py`` phase 22f holds this checkout
to without the other source.  ``--time`` then times K4, K5 and K6 of
both builds over one train step's launches of the MediaPipe model (64
clips x T=300, V=33), fp32 and bf16, in the order other, this, this,
other.  Prints the card's name and power limit."""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from shift_gcn_torch import kernels  # noqa: E402
from shift_gcn_torch.ops import shift_gcn_kernel as sk  # noqa: E402


def build_old(source: Path) -> ctypes.CDLL:
    out = REPO / "_proof" / "libshift_gcn_old.so"
    out.parent.mkdir(exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(source)], check=True)
    lib = ctypes.CDLL(str(out))
    kernels._declare("shift_gcn", lib)
    return lib


# K4, K5 and K6 through a build's C interface directly
def call_k4(lib, x, gate, w, b, d0=0):
    r, v, c = x.shape
    d = w.shape[1]
    out = torch.empty((r, v, d), dtype=x.dtype, device=x.device)
    assert lib.shift_gcn_forward(
        x.data_ptr(), gate.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), r, v, c, d, d0, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream) == 0
    return out


def call_k5(lib, g, gate, w, d0=0):
    r, v, d = g.shape
    c = w.shape[0]
    dx = torch.empty((r, v, c), dtype=g.dtype, device=g.device)
    assert lib.shift_gcn_dx(
        g.data_ptr(), gate.data_ptr(), w.data_ptr(), dx.data_ptr(), r, v, c,
        d, d0, int(g.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream) == 0
    return dx


def call_k6(lib, x, g, gate, w, d0=0):
    r, v, c = x.shape
    d = w.shape[1]
    parts, chunk = sk.wgrad_split(r, v, c, d)
    scratch = lib.shift_gcn_wgrad_scratch(r, v, c, d, d0, parts, chunk)
    partial = torch.empty(scratch, dtype=torch.float32, device=x.device)
    dgate = torch.empty((v, c), dtype=torch.float32, device=x.device)
    dw = torch.empty((c, d), dtype=torch.float32, device=x.device)
    dbias = torch.empty((d,), dtype=torch.float32, device=x.device)
    assert lib.shift_gcn_wgrad(
        x.data_ptr(), g.data_ptr(), gate.data_ptr(), w.data_ptr(),
        partial.data_ptr(), scratch, dgate.data_ptr(), dw.data_ptr(),
        dbias.data_ptr(), r, v, c, d, d0, parts, chunk,
        int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream) == 0
    return dgate, dw, dbias


def old_kernels(lib, x, g, gate, w, b, d0=0):
    """(K4 out, K5 dx, K6 (dgate, dW, dbias)) of the other build."""
    return (call_k4(lib, x, gate, w, b, d0), call_k5(lib, g, gate, w, d0),
            call_k6(lib, x, g, gate, w, d0))


def time_builds(old, dev) -> None:
    """K4, K5 and K6 of both builds, ms over a train step's launches at 64
    clips x T=300, V=33 (chip_smoke.py's K4 shapes and counts), each
    timed in the rounds other, this, this, other."""
    from shift_gcn_torch.models.shift_gcn import ModelConfig

    # both builds through the same direct calls, so that the host's share
    # of a timed call is the same on both sides
    libs = {"other": old, "this": kernels.library("shift_gcn")}
    calls = {build: (lambda x, g, gate, w, b, lib=lib: call_k4(lib, x, gate,
                                                                w, b),
                     lambda x, g, gate, w, b, lib=lib: call_k5(lib, g, gate,
                                                                w),
                     lambda x, g, gate, w, b, lib=lib: call_k6(lib, x, g,
                                                                gate, w))
             for build, lib in libs.items()}
    rounds = ("other", "this", "this", "other")
    shapes = chip_smoke.forward_shapes(ModelConfig(num_class=2), 300)[1]
    gen = torch.Generator(device=dev).manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        totals = {}
        for t, c, d in sorted(set(shapes)):
            count = shapes.count((t, c, d))
            r = 64 * t
            args = (torch.randn(r, 33, c, generator=gen,
                                device=dev).to(dtype),
                    torch.randn(r, 33, d, generator=gen,
                                device=dev).to(dtype),
                    torch.tanh(torch.randn(33, c, generator=gen,
                                           device=dev)) + 1.0,
                    torch.randn(c, d, generator=gen, device=dev) * d ** -0.5,
                    torch.randn(d, generator=gen, device=dev) * 0.1)
            for i, build in enumerate(rounds):
                for kernel, fn in zip(("K4", "K5", "K6"), calls[build]):
                    totals[i, kernel] = totals.get((i, kernel), 0.0) + (
                        count * chip_smoke.time_ms(lambda: fn(*args),
                                                   iters=5, reps=3))
        for kernel in ("K4", "K5", "K6"):
            print(f"[bitcheck] {kernel} {str(dtype)[6:]}, ms over a step's "
                  "launches (64 clips x T=300, V=33), rounds "
                  + ", ".join(f"{b} {totals[i, kernel]:.4f}"
                              for i, b in enumerate(rounds)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", type=Path)
    ap.add_argument("--write-digests", type=Path, default=None)
    ap.add_argument("--time", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script runs only on a GPU")
    old = build_old(args.source)
    dev = torch.device("cuda", 0)
    want = chip_smoke.v144_digests(
        lambda *a: old_kernels(old, *a), dev)
    got = chip_smoke.v144_digests(chip_smoke.new_kernels, dev)
    differ = [k for k in want if got[k] != want[k]]
    if differ:
        sys.exit(f"{len(differ)} of {len(want)} outputs not bit-equal to "
                 f"the other build, first {differ[:5]}")
    # the comparison can fail: a nonzero d0 moves the shears
    gen = torch.Generator(device=dev).manual_seed(0)
    v = 33
    x = torch.randn(64 * 75, v, 64, generator=gen, device=dev)
    g = torch.randn(64 * 75, v, 32, generator=gen, device=dev)
    gate = torch.tanh(torch.randn(v, 64, generator=gen, device=dev)) + 1.0
    w = torch.randn(64, 32, generator=gen, device=dev) * 32 ** -0.5
    b = torch.randn(32, generator=gen, device=dev) * 0.1
    base = chip_smoke.flat_outputs(old_kernels(old, x, g, gate, w, b))
    moved = [name for name, a in chip_smoke.flat_outputs(
        chip_smoke.new_kernels(x, g, gate, w, b, 32)).items()
        if not torch.equal(a, base[name])]
    if not {"K4", "K5", "K6 dW", "K6 dgate"} <= set(moved):
        sys.exit(f"d0 = 32 changed only {moved}: K4, K5, dgate and dW read "
                 "the shear on d")
    if args.write_digests is not None:
        args.write_digests.write_text(json.dumps(want, indent=0,
                                                 sort_keys=True) + "\n")
    if args.time:
        time_builds(old, dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[bitcheck] K4, K5 and K6 (dgate, dW, dbias) bit-equal to "
          f"{args.source}'s build: {len(want)} outputs (V = "
          f"{chip_smoke.V144_JOINTS}, {chip_smoke.V144_CLIPS} clips, fp32 "
          f"and bf16, d0 {chip_smoke.V144_D0}); at d0 = 32 against its d0 "
          f"= 0 the outputs that read the shear on d differ "
          f"({', '.join(moved)})"
          + (f"; digests written to {args.write_digests}"
             if args.write_digests else "") + f" | {card}")


if __name__ == "__main__":
    main()
