"""Multi-stream score ensemble + classification metrics.

A numpy copy of the reference package's ``ensemble.py``: the reference
ensemble tools (ensemble.py:18-36 keyed by sample index;
ensemble_mediapipe.py:20-50 keyed by sample name, plus binary
classification report and confusion matrix) over the score pickles the
trainer writes (eval_results/best_acc.pkl, and best_acc_<stream>.pkl
from a four-stream run).

    python -m shift_gcn_torch.ensemble --label val_label.pkl \
        --scores joint.pkl bone.pkl joint_motion.pkl bone_motion.pkl \
        [--alpha 0.6 0.6 0.4 0.4] [--binary-report]
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# reference alpha: same hyperparameter for NTU/NTU120/NW-UCLA
# (ensemble.py:19) and mediapipe (ensemble_mediapipe.py:16)
DEFAULT_ALPHA = (0.6, 0.6, 0.4, 0.4)


def load_scores(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return pickle.load(f)


def load_labels(path: str) -> Tuple[List[str], List[int]]:
    with open(path, "rb") as f:
        try:
            names, labels = pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            names, labels = pickle.load(f, encoding="latin1")
    return list(names), [int(l) for l in labels]


def ensemble_scores(
    score_dicts: Sequence[Dict[str, np.ndarray]],
    names: Sequence[str],
    alpha: Sequence[float] = DEFAULT_ALPHA,
) -> np.ndarray:
    """Weighted sum of per-stream scores, ordered by `names`. (N, num_class)."""
    if len(score_dicts) != len(alpha):
        raise ValueError(
            f"{len(score_dicts)} streams but {len(alpha)} weights")
    out = None
    for scores, a in zip(score_dicts, alpha):
        arr = np.stack([np.asarray(scores[name]) for name in names])
        out = arr * a if out is None else out + arr * a
    return out


def ensemble_scores_by_index(
    score_dicts: Sequence[Dict[object, np.ndarray]],
    alpha: Sequence[float] = DEFAULT_ALPHA,
) -> np.ndarray:
    """Index-keyed fusion (reference ensemble.py:18-27): streams are fused
    by sample *position* in each pickle's insertion order, for NTU score
    files whose keys need no name alignment.  (N, num_class)."""
    if len(score_dicts) != len(alpha):
        raise ValueError(
            f"{len(score_dicts)} streams but {len(alpha)} weights")
    n = len(score_dicts[0])
    for d in score_dicts[1:]:
        if len(d) != n:
            raise ValueError("streams disagree on sample count")
    out = None
    for scores, a in zip(score_dicts, alpha):
        arr = np.stack([np.asarray(v) for v in scores.values()])
        out = arr * a if out is None else out + arr * a
    return out


def top_k_accuracy(scores: np.ndarray, labels: Sequence[int],
                   k: int) -> float:
    rank = scores.argsort(axis=1)
    hit = [l in rank[i, -k:] for i, l in enumerate(labels)]
    return sum(hit) / len(hit)


def confusion_matrix(labels: Sequence[int], preds: Sequence[int],
                     num_class: int) -> np.ndarray:
    cm = np.zeros((num_class, num_class), dtype=np.int64)
    for l, p in zip(labels, preds):
        cm[l, p] += 1
    return cm


def binary_metrics(labels: Sequence[int],
                   preds: Sequence[int]) -> Dict[str, float]:
    """Precision/recall/F1 for the positive (fall) class — the headline
    metrics of the reference fall-detection report (README.md:60)."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    tp = int(np.sum((preds == 1) & (labels == 1)))
    fp = int(np.sum((preds == 1) & (labels == 0)))
    fn = int(np.sum((preds == 0) & (labels == 1)))
    tn = int(np.sum((preds == 0) & (labels == 0)))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"precision": precision, "recall": recall, "f1": f1,
            "tp": tp, "fp": fp, "fn": fn, "tn": tn}


def run_ensemble(
    label_path: str,
    score_paths: Sequence[str],
    alpha: Sequence[float] = DEFAULT_ALPHA,
    *,
    binary_report: bool = False,
) -> Dict[str, object]:
    """Full ensemble evaluation. Returns metrics dict (and prints nothing —
    the CLI wrapper handles presentation)."""
    names, labels = load_labels(label_path)
    score_dicts = [load_scores(p) for p in score_paths]
    name_set = set(names)
    if all(name_set.isdisjoint(d) for d in score_dicts):
        # NTU pkls keyed by something other than sample name (ZERO keys
        # match): use the reference's index-keyed fusion (ensemble.py:18-27).
        # Partial overlap stays a loud KeyError below — silent positional
        # fusion there could misalign streams against the labels.
        import warnings

        warnings.warn(
            "ensemble: score keys share nothing with the label sample "
            "names; falling back to POSITIONAL (insertion-order) fusion — "
            "equal-length score files whose order differs from the label "
            "order would fuse misaligned", stacklevel=2)
        scores = ensemble_scores_by_index(score_dicts, alpha)
        if scores.shape[0] != len(names):
            raise ValueError(
                f"index-keyed fusion: {scores.shape[0]} scores vs "
                f"{len(names)} labels")
    else:
        scores = ensemble_scores(score_dicts, names, alpha)
    preds = scores.argmax(axis=1)
    num_class = scores.shape[1]
    result: Dict[str, object] = {
        "top1": top_k_accuracy(scores, labels, 1),
        "top5": top_k_accuracy(scores, labels, min(5, num_class)),
        "confusion": confusion_matrix(labels, preds, num_class),
    }
    if binary_report and num_class == 2:
        result["binary"] = binary_metrics(labels, preds)
    return result


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="multi-stream ensemble")
    parser.add_argument("--label", required=True,
                        help="val_label.pkl path")
    parser.add_argument("--scores", nargs="+", required=True,
                        help="per-stream best_acc.pkl paths (joint, bone, "
                        "joint_motion, bone_motion order)")
    parser.add_argument("--alpha", nargs="+", type=float,
                        default=list(DEFAULT_ALPHA))
    parser.add_argument("--binary-report", action="store_true")
    args = parser.parse_args(argv)

    result = run_ensemble(args.label, args.scores, args.alpha,
                          binary_report=args.binary_report)
    print("top1: ", result["top1"])
    print("top5: ", result["top5"])
    cm = result["confusion"]
    if "binary" in result:
        b = result["binary"]
        print("\n--- Classification Report (Fall) ---")
        print(f"precision: {b['precision']:.4f}  recall: {b['recall']:.4f}  "
              f"f1: {b['f1']:.4f}")
        print("--- Confusion Matrix ---")
        print("              Pred Non-Fall  Pred Fall")
        print(f"  Non-Fall    {cm[0, 0]:>12}  {cm[0, 1]:>9}")
        print(f"  Fall        {cm[1, 0]:>12}  {cm[1, 1]:>9}")
    else:
        print("confusion matrix:\n", cm)


if __name__ == "__main__":
    main()
