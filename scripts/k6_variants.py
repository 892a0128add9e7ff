"""Time design variants of K6 (``shift_gcn_wgrad``) past one joint group,
on the card.

    python3 scripts/k6_variants.py [--parent OLD_SHIFT_GCN_CU]

Each variant is a copy of ``csrc/shift_gcn.cu`` with one design choice
of K6's joint-group path (V > 33) undone by a text substitution (it
raises if the source no longer matches); all are built with ``nvcc`` in
parallel into ``_build/k6_variants/`` (``-Xptxas -v``: each build's
registers and spill bytes are printed), loaded with ``ctypes``, held to
the plain version (2e-5 of scale, and bit-equal across two launches) at
V = 145 and 543 on the default backbone's launch shapes with 8 clips,
fp32 and bf16, and timed over one train step's launches at V=543 (8
clips x T=300), fp32 and bf16, in turns (the builds in order, then in
reverse; the mean of the two).  Two variants are halves of the kernel,
wrong by design and not checked: "copy only" skips the multiply and
"multiply only" copies the first stage alone.  With ``--parent``, an
earlier commit's source (with this checkout's C interface) is built and
timed beside them with the split it was built for
(``wgrad_wave_split``).  The GB each layout stages from L2 a step
(``wgrad_staged_bytes``), the plain version's time and the card's name
and power limit end the output.  Fails without CUDA."""

from __future__ import annotations

import argparse
import ctypes
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

SOURCE = kernels.CSRC / "shift_gcn.cu"
BUILD = kernels.BUILD_DIR / "k6_variants"
CLIPS, V, CHECK_JOINTS = 8, 543, (145, 543)

_MAPS = ("    s.tma_x = s.vec_x && wg_tensor_map<T>(&maps.x, x, r, v, c, "
         "s.rows);\n    s.tma_g = s.vec_g && wg_tensor_map<T>(&maps.g, g, "
         "r, v, d, s.rows);")
_JOINT = ("    for (int jj = 0; jj < kWgJoints; ++jj) {\n"
          "      const int uu = uus[jj];\n")
_SPLIT = """  big = tf32_rna(a);
  small = tf32_rna(a - __uint_as_float(big));"""
# name -> (substitutions that undo one choice, joints a group at most,
# input dtypes it runs, checked against the plain version)
VARIANTS = {
    "committed": ([], 33, ("float32", "bfloat16"), True),
    "no tensor copies": ([(_MAPS, "    s.tma_x = s.tma_g = false;")], 33,
                         ("float32", "bfloat16"), True),
    "three stages, 30 joints": (
        [("constexpr int kWgStages = 2;", "constexpr int kWgStages = 3;"),
         ("constexpr int kWgMaxWarps = 11;",
          "constexpr int kWgMaxWarps = 10;")], 30, ("float32",), True),
    "truncated TF32 split": (
        [(_SPLIT, "  big = __float_as_uint(a) & 0xffffe000u;\n"
                  "  small = __float_as_uint(a - __uint_as_float(big));")],
        33, ("float32",), True),
    "copy only": ([(_JOINT, _JOINT + "      if (kStrips && s.r >= 0) "
                                     "continue;\n")], 33,
                  ("float32", "bfloat16"), False),
    "multiply only": (
        [("    if (next < steps) issue(next, next % kStages);",
          "    if (next < steps && !kStrips) issue(next, next % kStages);"),
         ("    if (kStrips && tma_bytes)\n      mbar_wait(",
          "    if (kStrips && tma_bytes && st == 0)\n      mbar_wait(")],
        33, ("float32", "bfloat16"), False),
}


def build(sources: dict) -> dict:
    """{name: loaded library} of {name: source text}, built in parallel;
    prints the joint-group K6 functions' registers and spills."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, lib = BUILD / f"v{i}.cu", BUILD / f"libv{i}.so"
        src.write_text(text)
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"nvcc failed for {name}:\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "wgrad_partial_kernel" in line \
                    and "Lb1E" in line:
                dtype = "bf16" if "bfloat16" in line else "fp32"
                print(f"[k6v] {name} {dtype}: {lines[i + 2].strip()}; "
                      f"{lines[i + 3].split(':', 1)[1].strip()}")
        libs[name] = ctypes.CDLL(str(lib))
        kernels._declare("shift_gcn", libs[name])
    return libs


def call(lib, x, g, gate, w, split):
    r, v, c = x.shape
    d = w.shape[1]
    parts, chunk = split(r, v, c, d)
    scratch = lib.shift_gcn_wgrad_scratch(r, v, c, d, 0, parts, chunk)
    partial = torch.empty(scratch, dtype=torch.float32, device=x.device)
    out = (torch.empty((v, c), device=x.device),
           torch.empty((c, d), device=x.device),
           torch.empty(d, device=x.device))
    kernels.check(lib.shift_gcn_wgrad(
        x.data_ptr(), g.data_ptr(), gate.data_ptr(), w.data_ptr(),
        partial.data_ptr(), scratch, *(t.data_ptr() for t in out), r, v, c,
        d, 0, parts, chunk, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream), "shift_gcn_wgrad")
    return out


def split_for(group: int):
    """``wgrad_split`` with at most ``group`` joints a group."""
    def split(r, v, c, d):
        saved, sk.WGRAD_GROUP = sk.WGRAD_GROUP, group
        try:
            return sk.wgrad_split.__wrapped__(r, v, c, d)
        finally:
            sk.WGRAD_GROUP = saved
    return split


def inputs(gen, dev, r, v, c, d, dtype):
    return (torch.randn(r, v, c, generator=gen, device=dev).to(dtype),
            torch.randn(r, v, d, generator=gen, device=dev).to(dtype),
            torch.tanh(torch.randn(v, c, generator=gen, device=dev)) + 1.0,
            torch.randn(c, d, generator=gen, device=dev) * d ** -0.5)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: this script runs only on a GPU")
    text = SOURCE.read_text()
    sources = {}
    for name, (subs, _, _, _) in VARIANTS.items():
        variant = text
        for old, new in subs:
            if variant.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer holds "
                                   f"{old!r}")
            variant = variant.replace(old, new)
        sources[name] = variant
    if args.parent is not None:
        sources["parent"] = args.parent.read_text()
    libs = build(sources)
    runs = {name: (split_for(group), dtypes)
            for name, (_, group, dtypes, _) in VARIANTS.items()}
    if args.parent is not None:
        runs["parent"] = (sk.wgrad_wave_split, ("float32", "bfloat16"))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    worst, failed = {}, []
    for v in CHECK_JOINTS:
        for t, c, d in chip_smoke.backbone_shapes():
            for dtype in (torch.float32, torch.bfloat16):
                x, g, gate, w = inputs(gen, dev, CLIPS * t, v, c, d, dtype)
                want = ss.shift_gcn_wgrad_reference(x, g, gate, w)
                for name, (_, _, dtypes, checked) in VARIANTS.items():
                    if not checked or str(dtype)[6:] not in dtypes:
                        continue
                    split = runs[name][0]
                    got = call(libs[name], x, g, gate, w, split)
                    again = call(libs[name], x, g, gate, w, split)
                    torch.cuda.synchronize()
                    for a, b, ref in zip(got, again, want):
                        err, scale = chip_smoke.max_err(a, ref)
                        worst[name] = max(worst.get(name, 0.0), err / scale)
                        if err > 2e-5 * scale or not torch.equal(a, b):
                            failed.append((name, v, (t, c, d), dtype))
                del x, g
    print("[k6v] max|err| / scale against the plain version at V "
          f"{CHECK_JOINTS}: " + ", ".join(f"{k} {e:.3g}"
                                          for k, e in worst.items())
          + f"; failed {failed}")

    shapes = chip_smoke.forward_shapes(ModelConfig(num_class=2), 300)[1]
    for dtype in (torch.float32, torch.bfloat16):
        names = [n for n, (_, dts) in runs.items() if str(dtype)[6:] in dts]
        totals = dict.fromkeys(names, 0.0)
        plain = 0.0
        for t, c, d in sorted(set(shapes)):
            count = shapes.count((t, c, d))
            x, g, gate, w = inputs(gen, dev, CLIPS * t, V, c, d, dtype)
            for name in names + names[::-1]:
                split = runs[name][0]
                totals[name] += count * chip_smoke.time_ms(
                    lambda: call(libs[name], x, g, gate, w, split),
                    iters=3, reps=3) / 2
            plain += count * chip_smoke.time_ms(
                lambda: ss.shift_gcn_wgrad_reference(x, g, gate, w),
                iters=2, reps=3)
            del x, g
        itemsize = dtype.itemsize
        staged = [sum(shapes.count(s_) * sk.wgrad_staged_bytes(
            CLIPS * s_[0], V, s_[1], s_[2], itemsize, strips) / 1e9
            for s_ in set(shapes)) for strips in (True, False)]
        print(f"[k6v] V={V} {str(dtype)[6:]}, ms over a step's launches "
              f"({CLIPS} clips x T=300): "
              + ", ".join(f"{k} {ms:.3f}" for k, ms in totals.items())
              + f"; plain {plain:.3f}; staged from L2 {staged[0]:.2f} GB "
              f"(strips), {staged[1]:.2f} GB (the window of joints + 31 "
              "rows)", flush=True)
    print(chip_smoke.card_line())
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
