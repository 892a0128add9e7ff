"""Offline bone/motion modality generation CLI.

Equivalent of the reference gen_bone_data*.py / gen_motion_data*.py scripts,
memmap-backed so the ~GB tensors stream instead of loading whole (a copy
of the reference package's ``data/gendata/modality_cli.py`` over this
package's graphs):

  python -m shift_gcn_torch.data.gendata.modality_cli \
      --data-dir ./data/mediapipe --graph mediapipe --sets train val
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
from numpy.lib.format import open_memmap

from shift_gcn_torch.graphs import get_graph


def gen_bone(data_dir: str, graph_name: str, split: str,
             chunk: int = 256) -> str:
    graph = get_graph(graph_name)
    parents = graph.bone_parents()
    src = np.load(os.path.join(data_dir, f"{split}_data_joint.npy"),
                  mmap_mode="r")
    n, c, t, v, m = src.shape
    out_path = os.path.join(data_dir, f"{split}_data_bone.npy")
    dst = open_memmap(out_path, dtype="float32", mode="w+",
                      shape=(n, c, t, v, m))
    for i in range(0, n, chunk):
        block = np.asarray(src[i:i + chunk])
        dst[i:i + chunk] = block - block[:, :, :, parents, :]
    dst.flush()
    return out_path


def gen_motion(data_dir: str, split: str, part: str,
               chunk: int = 256) -> str:
    src = np.load(os.path.join(data_dir, f"{split}_data_{part}.npy"),
                  mmap_mode="r")
    n, c, t, v, m = src.shape
    out_path = os.path.join(data_dir, f"{split}_data_{part}_motion.npy")
    dst = open_memmap(out_path, dtype="float32", mode="w+",
                      shape=(n, c, t, v, m))
    for i in range(0, n, chunk):
        block = np.asarray(src[i:i + chunk])
        motion = np.zeros_like(block)
        motion[:, :, :-1] = block[:, :, 1:] - block[:, :, :-1]
        dst[i:i + chunk] = motion
    dst.flush()
    return out_path


def main(argv: List[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="bone/motion generator")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--graph", required=True,
                        help="topology name (ntu, mediapipe, ...)")
    parser.add_argument("--sets", nargs="+", default=["train", "val"])
    parser.add_argument("--skip-bone", action="store_true")
    parser.add_argument("--skip-motion", action="store_true")
    args = parser.parse_args(argv)

    for split in args.sets:
        if not args.skip_bone:
            print(f"bone: {split}")
            gen_bone(args.data_dir, args.graph, split)
        if not args.skip_motion:
            for part in ("joint", "bone"):
                print(f"motion: {split} {part}")
                gen_motion(args.data_dir, split, part)


if __name__ == "__main__":
    main()
