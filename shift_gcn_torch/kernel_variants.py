"""Time design variants of the temporal-shift forward kernel (K1) on a GPU.

    python3 -m shift_gcn_torch.kernel_variants [--seed N]

Each variant is a copy of ``csrc/temporal_shift.cu`` with one design
choice of ``tshift_forward_kernel`` undone by a text substitution; all are
built with ``nvcc`` in parallel into ``_build/variants/``, loaded with
``ctypes``, held bit-equal to the plain version
(``temporal_shift_reference``) on a few inputs, and timed per stream
forward of the serving model (64 windows, T=300, V=33, the 20 launches
of ``chip_smoke.forward_shapes``), fp32 and bf16, at the model's init
shifts U(-1, 1) and at spread-out ones U(-7, 7), in turns (the variants
in order, then in reverse; the better of the two).  A ``copy_`` of the
stride-1 launches' input is printed beside them as the rate a plain
device copy reaches on the same card.  Fails without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from shift_gcn_torch import kernels
from shift_gcn_torch.ops import temporal_shift as ts

SOURCE = kernels.CSRC / "temporal_shift.cu"
BUILD = kernels.BUILD_DIR / "variants"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
N_WINDOWS, V = 64, 33
# per stream forward: (T_in, C, stride) of each K1 launch
FORWARD = ([(300, 64, 1)] * 8 + [(300, 128, 1), (300, 128, 2)]
           + [(150, 128, 1)] * 4 + [(150, 256, 1), (150, 256, 2)]
           + [(75, 256, 1)] * 4)

_LAUNCH_BOUNDS = ("__launch_bounds__(ForwardTile<T, S, VEC>::kThreads,\n"
                  "                                  kFwdBlocks)")
_WINDOW = "window_frames<T, VEC>(v, 1 << 20, kFwdBlocks, &w, &bytes);"
_STORE_1 = ("template <typename T>\n__device__ __forceinline__ void "
            "store_vec(T* p, const float (&o)[1]) {")
_STORE_8 = """__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&o)[8]) {
  __stcs(reinterpret_cast<uint4*>(p),
         make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                    pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7])));
}
"""
# name -> substitutions (old, new) that undo one choice of the kernel
VARIANTS = {
    "committed": [],
    "fp32 rows not rotated": [
        ("  return (word & ~3) | ((word + (q >> (S - 1))) & 3);",
         "  return word;")],
    "fp32 16-byte copies, not rotated": [
        ("constexpr bool kRotated = VEC > 1 && sizeof(T) == 4;",
         "constexpr bool kRotated = false;")],
    "bf16 8-byte copies": [
        ("  } else if (sizeof(T) == 2 && VEC > 1 && c % 8 == 0 &&",
         "  } else if (false &&")],
    "4 joints in flight": [
        ("constexpr int kFwdUnroll = 2;", "constexpr int kFwdUnroll = 4;")],
    "window of the run + 6": [
        (_WINDOW, "window_frames<T, VEC>(v, (kRun - 1) * S + 8, "
                  "kFwdBlocks, &w, &bytes);")],
    "bf16 3 blocks an SM": [
        (_LAUNCH_BOUNDS, "__launch_bounds__(ForwardTile<T, S, VEC>::kThreads,"
                         " sizeof(T) == 2 ? 3 : 2)"),
        (_WINDOW, "window_frames<T, VEC>(v, 1 << 20, sizeof(T) == 2 ? 3 : 2,"
                  " &w, &bytes);")],
    "bf16 8-element lanes": [
        ("  constexpr int kV = kVec;",
         "  constexpr int kV = sizeof(T) == 2 ? 8 : kVec;"),
        (_STORE_1, _STORE_8 + _STORE_1)],
}


def build() -> dict:
    """{variant: loaded library}, built in parallel; raises on a failed
    build or a substitution that no longer matches the source."""
    BUILD.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    jobs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = text
        for old, new in subs:
            if old not in src:
                raise RuntimeError(f"variant {name!r}: {old!r} not in source")
            src = src.replace(old, new)
        cu = BUILD / f"v{i}.cu"
        cu.write_text(src)
        lib = BUILD / f"libv{i}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(lib), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{out}")
        print(f"[ptxas] {name}: {forward_resources(out)}")
        libs[name] = ctypes.CDLL(str(lib))
        kernels._declare("temporal_shift", libs[name])
    return libs


def forward_resources(ptxas: str) -> str:
    """Registers and spill-store bytes of each vector-lane forward kernel
    in ``-Xptxas -v`` output."""
    found, kernel = [], None
    for line in ptxas.splitlines():
        match = re.search(r"entry function '(\w*tshift_forward_kernel"
                          r"I(f|13__nv_bfloat16)Li(\d)ELi4E\w*)'", line)
        if match:
            kernel = (("fp32" if match.group(2) == "f" else "bf16")
                      + f" s={match.group(3)}")
        elif "Compiling entry function" in line:
            kernel = None
        elif kernel and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif kernel and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            found.append(f"{kernel} {regs} registers, {spill} B spilled")
            kernel = None
    return "; ".join(sorted(found))


def launch(lib, x: torch.Tensor, ypos: torch.Tensor,
           stride: int) -> torch.Tensor:
    n, t_in, v, c = x.shape
    out = torch.empty((n, t_in // stride, v, c), dtype=x.dtype,
                      device=x.device)
    kernels.check(lib.temporal_shift_forward(
        x.data_ptr(), ypos.data_ptr(), out.data_ptr(), n, t_in,
        t_in // stride, v, c, stride, int(x.dtype == torch.bfloat16),
        kernels.stream(x)), "temporal_shift")
    return out


def time_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median over reps of the mean of iters calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def positions(rng, c: int, spread: float) -> np.ndarray:
    return rng.uniform(-spread, spread, c).astype(np.float32)


def check(libs, gen, rng, dev) -> None:
    """Every variant bit-equal to the plain version: a stride-1 and a
    stride-2 serving shape, C=36 (a partial slab), T=17 and an unaligned
    input, at shifts inside and outside the staged window."""
    cases = [((300, 64, 1), 1.0, False), ((150, 256, 2), 7.0, False),
             ((17, 36, 2), 7.0, False), ((75, 128, 1), 7.0, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for (t, c, stride), spread, unaligned in cases:
            x = torch.randn(N_WINDOWS, t, V, c, generator=gen,
                            device=dev).to(dtype)
            if unaligned:
                buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
                buf[1:].copy_(x.view(-1))
                x = buf[1:].view(x.shape)
            ypos = torch.from_numpy(positions(rng, c, spread)).to(dev)
            want = ts.temporal_shift_reference(x, ypos, stride)
            for name, lib in libs.items():
                got = launch(lib, x, ypos, stride)
                if not torch.equal(got, want):
                    sys.exit(f"FAIL: {name} {dtype} T={t} C={c} s={stride}: "
                             "not bit-equal to the plain version")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("FAIL: CUDA is not available: this script runs on a GPU")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    t0 = time.perf_counter()
    libs = build()
    print(f"[variants] {len(libs)} builds in {time.perf_counter() - t0:.1f} s"
          f" | {card}")
    check(libs, gen, rng, dev)
    print("[variants] every variant bit-equal to the plain version")
    shapes = sorted(set(FORWARD))
    for dtype in (torch.float32, torch.bfloat16):
        copy = moved = 0.0
        for t, c, stride in shapes:
            if stride != 1:
                continue
            x = torch.randn(N_WINDOWS, t, V, c, generator=gen,
                            device=dev).to(dtype)
            y = torch.empty_like(x)
            copy += FORWARD.count((t, c, stride)) * time_ms(
                lambda: y.copy_(x))
            moved += FORWARD.count((t, c, stride)) * 2 * x.nbytes
        print(f"[copy] {str(dtype)[6:]}: copy_ of the stride-1 launches' "
              f"input {copy:.4f} ms, {moved / copy / 1e9:.3f} TB/s | {card}")
        for spread in (1.0, 7.0):
            totals = dict.fromkeys(libs, 0.0)
            bound = 0.0
            for t, c, stride in shapes:
                count = FORWARD.count((t, c, stride))
                x = torch.randn(N_WINDOWS, t, V, c, generator=gen,
                                device=dev).to(dtype)
                ypos = torch.from_numpy(positions(rng, c, spread)).to(dev)
                bound += count * (x.nbytes * (1 + 1 / stride) + 4 * c) \
                    / HBM_BYTES_PER_S * 1e3
                runs = {name: [] for name in libs}
                for name in list(libs) + list(libs)[::-1]:
                    runs[name].append(time_ms(
                        lambda: launch(libs[name], x, ypos, stride)))
                for name in libs:
                    totals[name] += count * min(runs[name])
            print(f"[time] K1 per forward, {str(dtype)[6:]}, ypos "
                  f"U(-{spread:g}, {spread:g}), bound {bound:.4f} ms: "
                  + "; ".join(f"{name} {ms:.4f} ms ({100 * bound / ms:.0f}%)"
                              for name, ms in totals.items())
                  + f" | {card}")


if __name__ == "__main__":
    main()
