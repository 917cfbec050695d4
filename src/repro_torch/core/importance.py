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
  * l1 / taylor / fpgm / hrank — data/sub-model-dependent criteria (break
    both), read from ``worker.local_unit_stats`` of the worker's own
    sub-model and shard

``grad_magnitude_scores`` is FedDST regrowth's grow signal.

The fused round engine (``core.fused``) prunes inside a chunk of rounds on
the device.  The ``STATIC_METHODS`` depend only on (seed, worker, prune
round, frozen global scales), so their removal orders are computed on the
host at a chunk boundary; the ``DEVICE_METHODS`` (l1, taylor) read the
worker's current sub-model and are scored on the device in float32 as
``[W, U]`` flat rows (``flat_scores``), non-retained slots at -inf as in
``worker.local_unit_stats``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = ["ImportanceContext", "METHODS", "DATA_DEPENDENT", "CIG_METHODS", "STATIC_METHODS",
           "DEVICE_METHODS", "grad_magnitude_scores", "flat_scores", "l1_scores",
           "taylor_scores"]

Scores = Dict[str, np.ndarray]

DATA_DEPENDENT = ("l1", "taylor", "fpgm", "hrank")


@dataclasses.dataclass
class ImportanceContext:
    """What a criterion may consult: base unit counts, the frozen global
    scales (CIG), the local sub-model's signals scattered to base units
    (-inf where a unit is absent): per-unit weight-group L2 norms, Taylor
    |g.w| terms and mean |activation|, and the (worker, round, seed) the
    seed-derived criteria draw from."""

    unit_counts: Mapping[str, int]
    scales: Optional[Scores] = None
    weight_norms: Optional[Scores] = None
    grads: Optional[Scores] = None
    activations: Optional[Scores] = None
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


def _l1(ctx: ImportanceContext) -> Scores:
    if ctx.weight_norms is None:
        raise ValueError("l1 needs weight_norms")
    return {k: np.asarray(v, np.float64) for k, v in ctx.weight_norms.items()}


def _taylor(ctx: ImportanceContext) -> Scores:
    if ctx.grads is None:
        raise ValueError("taylor needs grads")
    return {k: np.asarray(v, np.float64) for k, v in ctx.grads.items()}


def _fpgm(ctx: ImportanceContext) -> Scores:
    """Geometric-median distance proxy: |norm - median(norm)| per layer
    (the reference's cheap surrogate of FPGM's filter distances)."""
    if ctx.weight_norms is None:
        raise ValueError("fpgm needs weight_norms")
    out = {}
    for k, v in ctx.weight_norms.items():
        v = np.asarray(v, np.float64)
        out[k] = np.abs(v - np.median(v))
    return out


def _hrank(ctx: ImportanceContext) -> Scores:
    if ctx.activations is None:
        raise ValueError("hrank needs activations")
    return {k: np.asarray(v, np.float64) for k, v in ctx.activations.items()}


def grad_magnitude_scores(
    grads: Mapping[str, np.ndarray],
    unit_map: Mapping[str, Sequence],
    unit_counts: Mapping[str, int],
) -> Scores:
    """FedDST/RigL grow signal: per-unit group sums of |grad| of the DENSE
    model in base coordinates (pruned slots carry real gradients there),
    accumulated in float64 so grow orders do not depend on the device's
    accumulation."""
    acc: Dict[str, np.ndarray] = {k: np.zeros(n, np.float64) for k, n in unit_counts.items()}
    for path, entries in unit_map.items():
        g = grads.get(path)
        if g is None:
            continue
        g = np.abs(np.asarray(g, np.float64))
        for lname, axis in entries:
            if lname not in acc:
                continue
            axes = tuple(i for i in range(g.ndim) if i != axis)
            acc[lname] += g.sum(axis=axes)
    return acc


METHODS: Dict[str, Callable[[ImportanceContext], Scores]] = {
    "cig_bnscalor": cig_scores_from_scales,
    "index": _index,
    "no_adjacent": _shared_random,
    "no_identical": _no_identical,
    "no_constant": _no_constant,
    "l1": _l1,
    "taylor": _taylor,
    "fpgm": _fpgm,
    "hrank": _hrank,
}

# the criteria that satisfy the Identical and Constant principles (nested
# sub-models)
CIG_METHODS = frozenset({"cig_bnscalor", "index", "no_adjacent"})

# data-independent criteria: their removal orders are host-exact integer
# permutations at a fused chunk boundary
STATIC_METHODS = CIG_METHODS | {"no_identical", "no_constant"}

# data-dependent criteria the fused engine scores on the device
DEVICE_METHODS = frozenset({"l1", "taylor"})


def flat_scores(
    per_layer: Mapping[str, torch.Tensor],   # {lname: [W, n_l]}
    layer_names: Sequence[str],
    presence: torch.Tensor,                  # [W, U] 0/1 flat presence
) -> torch.Tensor:
    """Per-layer score rows concatenated in flat-slot order, non-retained
    slots at -inf."""
    flat = torch.cat([per_layer[name] for name in layer_names], dim=1)
    return torch.where(presence > 0, flat, torch.full_like(flat, -np.inf))


def l1_scores(weight_norms, layer_names, presence) -> torch.Tensor:
    """L1 on the device: per-unit group norms of the masked stacks."""
    return flat_scores(weight_norms, layer_names, presence)


def taylor_scores(grad_weight, layer_names, presence) -> torch.Tensor:
    """Taylor |g.w| on the device."""
    return flat_scores(grad_weight, layer_names, presence)
