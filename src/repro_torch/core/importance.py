"""Unit-importance criteria for distributed pruning (AdaptCL §III-D, Fig. 2).

Port of the host criteria of ``repro/core/importance.py``.  A criterion
returns a float64 score per prunable unit (higher = keep); ``masks``'s
``prune_to_budget`` cuts the lowest-scored retained units.

  * cig_bnscalor — CIG-BNscalor: |BN gamma| of the aggregated global model,
    frozen at the first pruning (Constant, Identical, Global)
  * index        — HeteroFL-style prefix retention (highest index first)
  * no_adjacent  — one shared random order, constant
  * no_identical — per-worker random rotation, constant (breaks Identical)
  * no_constant  — shared rotation re-drawn each round (breaks Constant)

The data-dependent criteria (l1, taylor, fpgm, hrank) are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import numpy as np

__all__ = ["ImportanceContext", "METHODS", "DATA_DEPENDENT"]

Scores = Dict[str, np.ndarray]

DATA_DEPENDENT = ("l1", "taylor", "fpgm", "hrank")


@dataclasses.dataclass
class ImportanceContext:
    """What a criterion may consult: base unit counts, the frozen global
    scales (CIG), and the (worker, round, seed) the seed-derived criteria
    draw from."""

    unit_counts: Mapping[str, int]
    scales: Optional[Scores] = None
    worker: int = 0
    round: int = 0
    seed: int = 0


def cig_scores_from_scales(ctx: ImportanceContext) -> Scores:
    """CIG-BNscalor: frozen global scale-magnitude ranking (paper §III-D)."""
    if ctx.scales is None:
        raise ValueError("cig_bnscalor needs the global BN scales")
    return {k: np.asarray(v, dtype=np.float64) for k, v in ctx.scales.items()}


def _index(ctx: ImportanceContext) -> Scores:
    return {k: -np.arange(n, dtype=np.float64) for k, n in ctx.unit_counts.items()}


def _shared_random(ctx: ImportanceContext) -> Scores:
    rng = np.random.default_rng(ctx.seed)  # NOT worker/round dependent
    return {
        k: rng.permutation(n).astype(np.float64)
        for k, n in sorted(ctx.unit_counts.items())
    }


def _rotated_index(n: int, start: int) -> np.ndarray:
    idx = np.arange(n)
    return -(((idx - start) % n).astype(np.float64))


def _no_identical(ctx: ImportanceContext) -> Scores:
    rng = np.random.default_rng((ctx.seed, ctx.worker))
    return {
        k: _rotated_index(n, int(rng.integers(n)))
        for k, n in sorted(ctx.unit_counts.items())
    }


def _no_constant(ctx: ImportanceContext) -> Scores:
    rng = np.random.default_rng((ctx.seed, ctx.round))
    return {
        k: _rotated_index(n, int(rng.integers(n)))
        for k, n in sorted(ctx.unit_counts.items())
    }


METHODS: Dict[str, Callable[[ImportanceContext], Scores]] = {
    "cig_bnscalor": cig_scores_from_scales,
    "index": _index,
    "no_adjacent": _shared_random,
    "no_identical": _no_identical,
    "no_constant": _no_constant,
}
