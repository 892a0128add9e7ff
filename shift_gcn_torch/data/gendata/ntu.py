"""NTU RGB+D skeleton dataset generation.

Parses the raw ``.skeleton`` text files and produces the (N, 3, 300, 25, 2)
float32 training tensors + (names, labels) pickles per benchmark/split,
with the same selection semantics as the reference
(data_gen/ntu_gendata.py / ntu120_gendata.py):

- top-2 bodies selected by motion "energy" = sum over joints of the
  coordinate std over frames (ntu_gendata.py:63-90),
- benchmarks: NTU-60 xsub (training subjects) / xview (training cameras
  2,3); NTU-120 xsub (106-subject split) / xsetup (even setups train),
- missing-skeleton exclusion: the dataset's published corrupt-sample
  manifests ship with the package (shift_gcn_torch/data/manifests/, the
  same lists the reference ships under data/nturgbd_raw/ and
  data/nturgbd120_raw/ — 302 NTU-60 + 535 NTU-120 entries) and are the
  CLI default; without them a rebuild silently ingests ~300 corrupt
  samples,
- pre_normalization applied batch-wise at the end.

A copy of the reference package's ``data/gendata/ntu.py`` (numpy only),
so that a port-only install turns raw skeletons into training tensors:

  python -m shift_gcn_torch.data.gendata.ntu --data-path <skeletons> \
      --out-folder ./data/ntu [--benchmark xsub xview] [--part train val]
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from shift_gcn_torch.data.preprocess import pre_normalization

MAX_BODY_KINECT = 4
MAX_BODY_TRUE = 2
NUM_JOINT = 25
MAX_FRAME = 300

# reference: data_gen/ntu_gendata.py:9-12
NTU60_TRAINING_SUBJECTS = (
    1, 2, 4, 5, 8, 9, 13, 14, 15, 16, 17, 18, 19, 25, 27, 28, 31, 34, 35, 38)
NTU60_TRAINING_CAMERAS = (2, 3)
# reference: data_gen/ntu120_gendata.py:9-13
NTU120_TRAINING_SUBJECTS = (
    1, 2, 4, 5, 8, 9, 13, 14, 15, 16, 17, 18, 19, 25, 27, 28, 31, 34, 35,
    38, 45, 46, 47, 49, 50, 52, 53, 54, 55, 56, 57, 58, 59, 70, 74, 78,
    80, 81, 82, 83, 84, 85, 86, 89, 91, 92, 93, 94, 95, 97, 98, 100, 103)
NTU120_TRAINING_SETUPS = tuple(range(2, 33, 2))

_MANIFEST_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "manifests")


def default_ignored_samples(benchmark: str) -> str:
    """Packaged missing-skeleton manifest for a benchmark.

    NTU-120 supersets NTU-60, so its benchmarks use the 535-entry list;
    the NTU-60 benchmarks use the 302-entry list (reference ships these
    as data/nturgbd_raw/NTU_RGBD_samples_with_missing_skeletons.txt and
    data/nturgbd120_raw/NTU_RGBD120_samples_with_missing_skeletons.txt).
    """
    name = ("NTU_RGBD120_samples_with_missing_skeletons.txt"
            if benchmark.startswith("ntu120")
            else "NTU_RGBD_samples_with_missing_skeletons.txt")
    return os.path.join(_MANIFEST_DIR, name)


def read_skeleton_file(path: str) -> Dict:
    """Parse one .skeleton file into frame/body/joint records
    (format per data_gen/ntu_gendata.py:22-60)."""
    with open(path) as f:
        num_frame = int(f.readline())
        frames = []
        for _ in range(num_frame):
            num_body = int(f.readline())
            bodies = []
            for _ in range(num_body):
                info = f.readline().split()
                body_id = info[0]
                num_joint = int(f.readline())
                joints = []
                for _ in range(num_joint):
                    vals = f.readline().split()
                    joints.append([float(vals[0]), float(vals[1]),
                                   float(vals[2])])
                bodies.append({"bodyID": body_id, "joints": joints})
            frames.append(bodies)
    return {"numFrame": num_frame, "frames": frames}


def _body_energy(body_seq: np.ndarray) -> float:
    """Motion energy of one (T, V, C) body: sum of per-joint coordinate std
    over frames with any data (reference: ntu_gendata.py:63-74)."""
    index = body_seq.sum(-1).sum(-1) != 0
    if not index.any():
        return 0.0
    sel = body_seq[index]
    return float(sel[:, :, 0].std() + sel[:, :, 1].std()
                 + sel[:, :, 2].std())


def read_xyz(path: str, max_body: int = MAX_BODY_KINECT,
             num_joint: int = NUM_JOINT) -> np.ndarray:
    """One file -> (3, T, V, MAX_BODY_TRUE), top-2 bodies by energy
    (reference: ntu_gendata.py:77-90)."""
    seq = read_skeleton_file(path)
    t = seq["numFrame"]
    # group frames by body slot via bodyID ordering within frame
    data = np.zeros((max_body, t, num_joint, 3), dtype=np.float32)
    for i_f, bodies in enumerate(seq["frames"]):
        for i_b, body in enumerate(bodies[:max_body]):
            joints = np.asarray(body["joints"], dtype=np.float32)
            data[i_b, i_f, :len(joints)] = joints[:num_joint]
    energies = np.array([_body_energy(b) for b in data])
    order = energies.argsort()[::-1][:MAX_BODY_TRUE]
    data = data[order]
    return data.transpose(3, 1, 2, 0)  # (3, T, V, M)


def parse_filename(name: str) -> Dict[str, int]:
    """SsssCcccPpppRrrrAaaa fields from an NTU sample name."""
    base = os.path.basename(name).split(".")[0]
    return {
        "setup": int(base[base.find("S") + 1:base.find("S") + 4]),
        "camera": int(base[base.find("C") + 1:base.find("C") + 4]),
        "subject": int(base[base.find("P") + 1:base.find("P") + 4]),
        "replication": int(base[base.find("R") + 1:base.find("R") + 4]),
        "action": int(base[base.find("A") + 1:base.find("A") + 4]),
    }


def is_training_sample(fields: Dict[str, int], benchmark: str) -> bool:
    if benchmark == "xsub":
        return fields["subject"] in NTU60_TRAINING_SUBJECTS
    if benchmark == "xview":
        return fields["camera"] in NTU60_TRAINING_CAMERAS
    if benchmark == "ntu120-xsub":
        return fields["subject"] in NTU120_TRAINING_SUBJECTS
    if benchmark == "ntu120-xsetup":
        return fields["setup"] in NTU120_TRAINING_SETUPS
    raise ValueError(f"unknown benchmark {benchmark!r}")


def gendata(
    data_path: str,
    out_path: str,
    ignored_samples_path: Optional[str] = None,
    benchmark: str = "xsub",
    part: str = "train",
    *,
    label_offset: int = 1,
) -> Tuple[str, str]:
    """Build {part}_data_joint.npy + {part}_label.pkl for one split
    (reference: ntu_gendata.py:93-147)."""
    ignored = set()
    if ignored_samples_path:
        with open(ignored_samples_path) as f:
            ignored = {line.strip() + ".skeleton" for line in f if line.strip()}

    names: List[str] = []
    labels: List[int] = []
    for filename in sorted(os.listdir(data_path)):
        if not filename.endswith(".skeleton") or filename in ignored:
            continue
        fields = parse_filename(filename)
        istrain = is_training_sample(fields, benchmark)
        if (part == "train") == istrain:
            names.append(filename)
            labels.append(fields["action"] - label_offset)

    data = np.zeros(
        (len(names), 3, MAX_FRAME, NUM_JOINT, MAX_BODY_TRUE), np.float32)
    for i, name in enumerate(names):
        clip = read_xyz(os.path.join(data_path, name))
        t = min(clip.shape[1], MAX_FRAME)
        data[i, :, :t] = clip[:, :t]

    data = pre_normalization(data)
    os.makedirs(out_path, exist_ok=True)
    data_file = os.path.join(out_path, f"{part}_data_joint.npy")
    label_file = os.path.join(out_path, f"{part}_label.pkl")
    np.save(data_file, data)
    with open(label_file, "wb") as f:
        pickle.dump((names, labels), f)
    return data_file, label_file


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="NTU data converter")
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--out-folder", required=True)
    parser.add_argument(
        "--ignored-sample-path", default="auto",
        help="missing-skeleton exclusion list; 'auto' (default) uses the "
             "packaged per-benchmark manifest, 'none' disables exclusion")
    parser.add_argument("--benchmark", nargs="+",
                        default=["xsub", "xview"])
    parser.add_argument("--part", nargs="+", default=["train", "val"])
    args = parser.parse_args(argv)
    for b in args.benchmark:
        for p in args.part:
            out = os.path.join(args.out_folder, b)
            ignored = args.ignored_sample_path
            if ignored == "auto":
                ignored = default_ignored_samples(b)
            elif ignored == "none":
                ignored = None
            print(b, p, f"(ignored: {ignored})")
            gendata(args.data_path, out, ignored, benchmark=b, part=p)


if __name__ == "__main__":
    main()
