"""Synthetic image task + the paper's Non-IID partition (host numpy).

Port of ``repro/data/synthetic.py`` (the parts the simulator uses).  The
data is drawn with numpy from the seed, exactly as the JAX package draws it,
so both packages train on byte-identical images and shards.

Non-IID partition follows AdaptCL §IV-A: (1-s%) of the data is split IID
across workers; the remaining s% is sorted by label and dealt sequentially —
every worker has the same amount of data but skewed classes.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

__all__ = ["SyntheticImageTask", "partition_noniid"]


@dataclasses.dataclass
class SyntheticImageTask:
    """Class-prototype images + noise; learnable but not trivial.
    Images are NHWC float32, labels int32."""

    num_classes: int = 10
    image_size: int = 32
    train_size: int = 5000
    test_size: int = 1000
    noise: float = 0.6
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        s = self.image_size
        # low-frequency class prototypes
        low = rng.normal(0, 1, (self.num_classes, 8, 8, 3))
        protos = np.stack([
            np.kron(low[c], np.ones((s // 8, s // 8, 1))) for c in range(self.num_classes)
        ])
        self.prototypes = protos / np.abs(protos).max()

        def make(n, seed):
            r = np.random.default_rng(seed)
            y = r.integers(0, self.num_classes, n)
            x = self.prototypes[y] + r.normal(0, self.noise, (n, s, s, 3))
            return x.astype(np.float32), y.astype(np.int32)

        self.x_train, self.y_train = make(self.train_size, self.seed + 1)
        self.x_test, self.y_test = make(self.test_size, self.seed + 2)


def partition_noniid(
    y: np.ndarray, num_workers: int, s_percent: float, seed: int = 0
) -> List[np.ndarray]:
    """AdaptCL Non-IID split: returns per-worker index arrays (equal sizes)."""
    n = len(y)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_sorted = int(n * s_percent / 100.0)
    iid_part, skew_part = perm[: n - n_sorted], perm[n - n_sorted :]
    skew_part = skew_part[np.argsort(y[skew_part], kind="stable")]
    shards: List[List[int]] = [[] for _ in range(num_workers)]
    for w in range(num_workers):
        shards[w].extend(iid_part[w::num_workers])
    chunk = len(skew_part) // num_workers
    for w in range(num_workers):
        lo = w * chunk
        hi = (w + 1) * chunk if w < num_workers - 1 else len(skew_part)
        shards[w].extend(skew_part[lo:hi])
    return [np.array(sh, dtype=np.int64) for sh in shards]
