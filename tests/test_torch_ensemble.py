"""The port's score ensemble (shift_gcn_torch.ensemble) against the
reference package's ensemble.py on the same pickles: bit-equal scores
and metrics, and the same CLI report."""

import pickle

import numpy as np
import pytest

from shift_gcn_tpu import ensemble as jax_ensemble
from shift_gcn_torch import ensemble


@pytest.fixture
def pickles(tmp_path):
    """A label pickle and four stream score pickles keyed by sample name,
    each in its own random order, as the trainer writes them."""
    rng = np.random.default_rng(0)
    n = 40
    names = [f"clip{i}" for i in range(n)]
    labels = rng.integers(0, 2, n).tolist()
    label_path = tmp_path / "val_label.pkl"
    with open(label_path, "wb") as f:
        pickle.dump((names, labels), f)
    paths = []
    for s in range(4):
        scores = rng.standard_normal((n, 2)).astype(np.float32)
        order = rng.permutation(n)
        path = tmp_path / f"stream{s}.pkl"
        with open(path, "wb") as f:
            pickle.dump({names[i]: scores[i] for i in order}, f)
        paths.append(str(path))
    return str(label_path), paths


def test_constants_and_loaders_match(pickles):
    label_path, paths = pickles
    assert ensemble.DEFAULT_ALPHA == jax_ensemble.DEFAULT_ALPHA
    assert ensemble.load_labels(label_path) == jax_ensemble.load_labels(
        label_path)
    got, want = ensemble.load_scores(paths[0]), jax_ensemble.load_scores(
        paths[0])
    assert list(got) == list(want)


@pytest.mark.parametrize("alpha", [(0.6, 0.6, 0.4, 0.4), (1.0, 0.5, 0.25,
                                                          0.0)])
def test_fusion_matches_reference(pickles, alpha):
    label_path, paths = pickles
    names, _ = ensemble.load_labels(label_path)
    dicts = [ensemble.load_scores(p) for p in paths]
    np.testing.assert_array_equal(
        ensemble.ensemble_scores(dicts, names, alpha),
        jax_ensemble.ensemble_scores(dicts, names, alpha))
    np.testing.assert_array_equal(
        ensemble.ensemble_scores_by_index(dicts, alpha),
        jax_ensemble.ensemble_scores_by_index(dicts, alpha))
    with pytest.raises(ValueError, match="weights"):
        ensemble.ensemble_scores(dicts[:3], names, alpha)


def test_metrics_match_reference():
    rng = np.random.default_rng(1)
    scores = rng.standard_normal((30, 5))
    labels = rng.integers(0, 5, 30).tolist()
    preds = scores.argmax(1)
    for k in (1, 3):
        assert ensemble.top_k_accuracy(scores, labels, k) == \
            jax_ensemble.top_k_accuracy(scores, labels, k)
    np.testing.assert_array_equal(
        ensemble.confusion_matrix(labels, preds, 5),
        jax_ensemble.confusion_matrix(labels, preds, 5))
    binary = [int(v) % 2 for v in labels]
    assert ensemble.binary_metrics(binary, preds % 2) == \
        jax_ensemble.binary_metrics(binary, preds % 2)


def test_run_ensemble_and_cli_match_reference(pickles, capsys):
    label_path, paths = pickles
    got = ensemble.run_ensemble(label_path, paths, binary_report=True)
    want = jax_ensemble.run_ensemble(label_path, paths, binary_report=True)
    assert set(got) == set(want) == {"top1", "top5", "confusion", "binary"}
    assert got["top1"] == want["top1"] and got["binary"] == want["binary"]
    np.testing.assert_array_equal(got["confusion"], want["confusion"])
    argv = ["--label", label_path, "--scores", *paths, "--binary-report"]
    ensemble.main(argv)
    ours = capsys.readouterr().out
    jax_ensemble.main(argv)
    assert ours == capsys.readouterr().out
    assert "Classification Report (Fall)" in ours
