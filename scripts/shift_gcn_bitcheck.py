"""K4, K5 and K6 of this checkout against another build of
``csrc/shift_gcn.cu`` (an earlier commit's, without the output-channel
offset ``d0``), bit for bit, on the card.

    git show <commit>:shift_gcn_torch/csrc/shift_gcn.cu > _proof/old.cu
    python3 scripts/shift_gcn_bitcheck.py _proof/old.cu

Builds the other source with the same nvcc flags into ``_proof/``, then
runs both builds on the same seeded inputs at every launch shape of one
train step of the MediaPipe model (64 clips x T=300: the forward's K4,
K5 and K6 at each unit's (T, C, D)), fp32 and bf16, this checkout's at
d0 = 0, and fails unless every output is bit-equal.  Then it compares
the other build against this checkout's at d0 = 32 on a narrow layer,
where the outputs that read the shear on d must differ (so the
comparison can fail).  Prints the card's name and power limit."""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from shift_gcn_torch import kernels  # noqa: E402
from shift_gcn_torch.ops import shift_gcn_kernel as sk  # noqa: E402

V, N, T = 33, 64, 300
# (T, C, D) of the backbone's units
SHAPES = ((300, 3, 64), (300, 64, 64), (300, 64, 128), (150, 128, 128),
          (150, 128, 256), (75, 256, 256))


def build_old(source: Path) -> ctypes.CDLL:
    out = REPO / "_proof" / "libshift_gcn_old.so"
    out.parent.mkdir(exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(source)], check=True)
    lib = ctypes.CDLL(str(out))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.shift_gcn_forward.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
    lib.shift_gcn_dx.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.shift_gcn_wgrad.argtypes = ([ptr] * 5 + [i64] + [ptr] * 3
                                    + [i32] * 7 + [ptr])
    lib.shift_gcn_wgrad_scratch.argtypes = [i32] * 6
    lib.shift_gcn_wgrad_scratch.restype = i64
    return lib


def old_kernels(lib, x, g, gate, w, b):
    """(K4 out, K5 dx, K6 (dgate, dW, dbias)) of the other build."""
    r, v, c = x.shape
    d = w.shape[1]
    bf16 = int(x.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((r, v, d), dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    assert lib.shift_gcn_forward(x.data_ptr(), gate.data_ptr(),
                                 w.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 r, v, c, d, bf16, stream) == 0
    assert lib.shift_gcn_dx(g.data_ptr(), gate.data_ptr(), w.data_ptr(),
                            dx.data_ptr(), r, v, c, d, bf16, stream) == 0
    parts, chunk = sk.wgrad_split(r, v, c, d)
    scratch = lib.shift_gcn_wgrad_scratch(r, v, c, d, parts, chunk)
    partial = torch.empty(scratch, dtype=torch.float32, device=x.device)
    dgate = torch.empty((v, c), dtype=torch.float32, device=x.device)
    dw = torch.empty((c, d), dtype=torch.float32, device=x.device)
    dbias = torch.empty((d,), dtype=torch.float32, device=x.device)
    assert lib.shift_gcn_wgrad(
        x.data_ptr(), g.data_ptr(), gate.data_ptr(), w.data_ptr(),
        partial.data_ptr(), scratch, dgate.data_ptr(), dw.data_ptr(),
        dbias.data_ptr(), r, v, c, d, parts, chunk, bf16, stream) == 0
    return out, dx, (dgate, dw, dbias)


def new_kernels(x, g, gate, w, b, d0=0):
    return (sk.shift_gcn_forward(x, gate, w, b, d0),
            sk.shift_gcn_dx(g, gate, w, d0),
            sk.shift_gcn_wgrad(x, g, gate, w, d0))


def flat(outs):
    out, dx, (dgate, dw, dbias) = outs
    return {"K4": out, "K5": dx, "K6 dgate": dgate, "K6 dW": dw,
            "K6 dbias": dbias}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script runs only on a GPU")
    old = build_old(Path(sys.argv[1]))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for t, c, d in SHAPES:
            x = torch.randn(N * t, V, c, generator=gen, device=dev).to(dtype)
            g = torch.randn(N * t, V, d, generator=gen, device=dev).to(dtype)
            gate = torch.tanh(torch.randn(V, c, generator=gen,
                                          device=dev)) + 1.0
            w = torch.randn(c, d, generator=gen, device=dev) * d ** -0.5
            b = torch.randn(d, generator=gen, device=dev) * 0.1
            want = flat(old_kernels(old, x, g, gate, w, b))
            got = flat(new_kernels(x, g, gate, w, b))
            torch.cuda.synchronize()
            for name, a in got.items():
                if not torch.equal(a, want[name]):
                    sys.exit(f"{name} {dtype} T={t} C={c} D={d}: not "
                             "bit-equal to the other build at d0 = 0")
                checked += 1
    # the comparison can fail: a nonzero d0 moves the shears
    x = torch.randn(N * 75, V, 64, generator=gen, device=dev)
    g = torch.randn(N * 75, V, 32, generator=gen, device=dev)
    gate = torch.tanh(torch.randn(V, 64, generator=gen, device=dev)) + 1.0
    w = torch.randn(64, 32, generator=gen, device=dev) * 32 ** -0.5
    b = torch.randn(32, generator=gen, device=dev) * 0.1
    want = flat(old_kernels(old, x, g, gate, w, b))
    moved = [name for name, a in flat(new_kernels(
        x, g, gate, w, b, 32)).items() if not torch.equal(a, want[name])]
    if not {"K4", "K5", "K6 dW", "K6 dgate"} <= set(moved):
        sys.exit(f"d0 = 32 changed only {moved}: K4, K5, dgate and dW read "
                 "the shear on d")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[bitcheck] K4, K5 and K6 (dgate, dW, dbias) at d0 = 0 bit-equal "
          f"to {sys.argv[1]}'s build: {checked} outputs at {len(SHAPES)} "
          f"shapes x fp32, bf16 ({N} clips x T={T}); at d0 = 32 the "
          f"outputs that read the shear on d differ ({', '.join(moved)}) "
          f"| {card}")


if __name__ == "__main__":
    main()
