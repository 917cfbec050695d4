"""Synthetic image task + the paper's Non-IID partition, and the token task
of the LLM trainer (host numpy).

Port of ``repro/data/synthetic.py``.  The data is drawn with numpy from the
seed, exactly as the JAX package draws it, so both packages train on
byte-identical images, shards, batches and token sequences.

Non-IID partition follows AdaptCL §IV-A: (1-s%) of the data is split IID
across workers; the remaining s% is sorted by label and dealt sequentially —
every worker has the same amount of data but skewed classes.  The scenario
layer's Dirichlet label skew (``partition_dirichlet``) is the other
partitioner.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

__all__ = ["SyntheticImageTask", "partition_dirichlet", "partition_noniid", "batch_iterator",
           "SyntheticLMTask"]


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


def partition_dirichlet(
    y: np.ndarray, num_workers: int, alpha: float, seed: int = 0
) -> List[np.ndarray]:
    """Dirichlet label-concentration Non-IID split (``ScenarioConfig.skew``).

    Each worker draws a class mixture ``p_w ~ Dir(alpha)`` (small alpha =
    near single-class shards, large alpha = IID); floor quotas per class are
    filled from shuffled per-class pools, then the leftover indices are dealt
    shuffled so every shard has EXACTLY ``n // num_workers`` samples — the
    resident engines stack shard data into ``[W, n_shard, ...]`` arrays and
    require equal sizes.  Pure host numpy on one dedicated ``default_rng``
    stream, so the assignment is a function of ``(y, W, alpha, seed)`` alone
    and every engine sees identical shards."""
    n = len(y)
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    pools = {
        int(c): rng.permutation(np.flatnonzero(y == c)).tolist()
        for c in classes
    }
    n_shard = n // num_workers
    mix = rng.dirichlet(np.full(len(classes), alpha), size=num_workers)
    shards: List[List[int]] = [[] for _ in range(num_workers)]
    for w in range(num_workers):
        quota = np.floor(mix[w] * n_shard).astype(np.int64)
        for ci, c in enumerate(classes):
            pool = pools[int(c)]
            take = min(int(quota[ci]), len(pool), n_shard - len(shards[w]))
            if take > 0:
                shards[w].extend(pool[:take])
                del pool[:take]
    leftover = [i for c in classes for i in pools[int(c)]]
    rng.shuffle(leftover)
    pos = 0
    for w in range(num_workers):
        need = n_shard - len(shards[w])
        shards[w].extend(leftover[pos : pos + need])
        pos += need
    return [np.sort(np.array(sh, dtype=np.int64)) for sh in shards]


def batch_iterator(
    x: np.ndarray, y: np.ndarray, batch_size: int, epochs: float, rng: np.random.Generator
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """`epochs` may be fractional (DC-ASGD uses E=0.5)."""
    n = len(x)
    total = int(round(epochs * n))
    done = 0
    while done < total:
        order = rng.permutation(n)
        for i in range(0, n, batch_size):
            if done >= total:
                return
            idx = order[i : i + batch_size]
            yield x[idx], y[idx]
            done += len(idx)


@dataclasses.dataclass
class SyntheticLMTask:
    """Token sequences from a sparse Markov chain (for transformer smoke/train)."""

    vocab_size: int = 512
    seq_len: int = 64
    seed: int = 0

    def sample(self, batch: int, rng: np.random.Generator) -> np.ndarray:
        trans = np.random.default_rng(self.seed).integers(
            0, self.vocab_size, (self.vocab_size, 4)
        )
        toks = np.empty((batch, self.seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, batch)
        for t in range(1, self.seq_len):
            choice = rng.integers(0, 4, batch)
            toks[:, t] = trans[toks[:, t - 1], choice]
        return toks
