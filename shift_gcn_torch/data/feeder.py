"""Skeleton clip feeder: mmap-backed dataset + deterministic batch iterator.

A numpy copy of the reference package's ``Feeder`` / ``BatchIterator``
(its own replacement of the reference torch Dataset/DataLoader,
feeders/feeder.py:11-95, main.py:231-251) for one process: the same
epoch permutations and augmentation draws from the same seed, so both
packages see the same batches.  Batches are built in the caller's thread
(no prefetch thread, no native loader).
"""

from __future__ import annotations

import pickle
from typing import Iterator, Optional, Tuple

import numpy as np

from shift_gcn_torch.data import augmentations as aug


class Feeder:
    """Dataset over (N, C, T, V, M) .npy data + (names, labels) pickle.

    Reference feeder semantics (feeders/feeder.py:41-90): optional
    mean/std normalization, random_shift, random_choose / auto-pad to
    window_size, random_move; ``debug`` truncates to the first 100
    samples.  The data file is memory-mapped.
    """

    def __init__(
        self,
        data_path: str,
        label_path: str,
        *,
        random_choose: bool = False,
        random_shift: bool = False,
        random_move: bool = False,
        window_size: int = -1,
        normalization: bool = False,
        debug: bool = False,
    ):
        self.data_path = data_path
        self.label_path = label_path
        self.random_choose = random_choose
        self.random_shift = random_shift
        self.random_move = random_move
        self.window_size = window_size
        self.normalization = normalization

        with open(label_path, "rb") as f:
            try:
                self.sample_name, self.label = pickle.load(f)
            except UnicodeDecodeError:
                f.seek(0)
                self.sample_name, self.label = pickle.load(
                    f, encoding="latin1")
        self.label = list(self.label)

        self.data = np.load(data_path, mmap_mode="r")
        if debug:
            self.label = self.label[:100]
            self.data = self.data[:100]
            self.sample_name = self.sample_name[:100]
        if normalization:
            self._compute_mean_map()

    def _compute_mean_map(self) -> None:
        # reference: feeders/feeder.py:62-66
        data = self.data
        n, c, t, v, m = data.shape
        self.mean_map = data.mean(axis=2, keepdims=True).mean(
            axis=4, keepdims=True).mean(axis=0)
        self.std_map = data.transpose((0, 2, 4, 1, 3)).reshape(
            (n * t * m, c * v)).std(axis=0).reshape((c, 1, v, 1))

    def __len__(self) -> int:
        return len(self.label)

    def get(self, index: int,
            rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Fetch one augmented clip (C, T, V, M) float32."""
        sample = np.array(self.data[index], dtype=np.float32)
        if self.normalization:
            sample = (sample - self.mean_map) / self.std_map
        if self.random_shift and rng is not None:
            sample = aug.random_shift(sample, rng)
        if self.random_choose and rng is not None:
            sample = aug.random_choose(sample, self.window_size, rng)
        elif self.window_size > 0:
            sample = aug.auto_pad(sample, self.window_size)
        if self.random_move and rng is not None:
            sample = aug.random_move(sample, rng)
        return sample.astype(np.float32)

    def top_k(self, score: np.ndarray, k: int) -> float:
        """Fraction of samples whose label is in the top-k scores
        (reference: feeders/feeder.py:92-95)."""
        rank = score.argsort()
        hit = [l in rank[i, -k:] for i, l in enumerate(self.label)]
        return sum(hit) * 1.0 / len(hit)


class BatchIterator:
    """Deterministic batch iterator.

    Each epoch draws a permutation from seed + 1000003 * epoch and the
    augmentations from seed + 7919 * epoch (the reference package's
    single-host streams).  With drop_last=False the final short batch is
    zero-padded to the batch size and a validity mask is emitted.
    """

    def __init__(self, feeder: Feeder, batch_size: int, *,
                 shuffle: bool = False, drop_last: bool = False,
                 seed: int = 1):
        self.feeder = feeder
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.feeder)
        if self.shuffle:
            return np.random.default_rng(
                self.seed + 1000003 * epoch).permutation(n)
        return np.arange(n)

    def batches_per_epoch(self) -> int:
        n = len(self.feeder)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _make_batch(
        self, idx: np.ndarray, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        data = np.stack([self.feeder.get(int(i), rng) for i in idx])
        labels = np.asarray([self.feeder.label[int(i)] for i in idx],
                            dtype=np.int32)
        mask = np.ones(len(idx), dtype=np.float32)
        if len(idx) < self.batch_size:
            pad = self.batch_size - len(idx)
            data = np.concatenate(
                [data, np.zeros((pad,) + data.shape[1:], data.dtype)])
            labels = np.concatenate([labels, np.zeros(pad, np.int32)])
            mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            idx = np.concatenate([idx, np.full(pad, -1, idx.dtype)])
        return data, labels, idx.astype(np.int32), mask

    def epoch(self, epoch: int) -> Iterator[
            Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Yield (data, label, index, mask) batches."""
        order = self._epoch_indices(epoch)
        rng = np.random.default_rng(self.seed + 7919 * epoch)
        for b in range(self.batches_per_epoch()):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield self._make_batch(idx, rng)
