"""Global-index (I_w) machinery: unit space, budgeted pruning, similarity.

Port of the host parts of ``repro/core/masks.py`` (pure numpy, no device
work).  Worker w's sub-model is identified by its *global index* ``I_w`` —
for each prunable layer, the sorted ids of the retained units with respect
to the base model.  Each layer advertises a per-unit parameter cost so pruned
rates are enforced in parameter space (the paper's budget is a fraction of
model size).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence

import numpy as np

__all__ = [
    "GlobalIndex",
    "UnitLayer",
    "UnitSpace",
    "full_index",
    "retention",
    "payload_bytes",
    "prune_to_budget",
    "similarity",
]

GlobalIndex = Dict[str, np.ndarray]


@dataclasses.dataclass(frozen=True)
class UnitLayer:
    """One prunable unit dimension of the base model."""

    name: str
    num_units: int
    unit_param_cost: int  # parameters attributable to ONE unit of this layer
    min_units: int = 1    # never prune a layer empty


@dataclasses.dataclass(frozen=True)
class UnitSpace:
    """Inventory of prunable units + the fixed (never-pruned) parameter mass."""

    layers: Sequence[UnitLayer]
    fixed_params: int

    @property
    def unit_counts(self) -> Dict[str, int]:
        return {l.name: l.num_units for l in self.layers}

    @property
    def total_params(self) -> int:
        return self.fixed_params + sum(
            l.num_units * l.unit_param_cost for l in self.layers
        )


def full_index(space: UnitSpace) -> GlobalIndex:
    return {l.name: np.arange(l.num_units) for l in space.layers}


def _retained_params(index: GlobalIndex, space: UnitSpace) -> int:
    return space.fixed_params + sum(
        len(index[l.name]) * l.unit_param_cost for l in space.layers
    )


def retention(index: GlobalIndex, space: UnitSpace) -> float:
    """gamma: retained parameter fraction of the base model."""
    return _retained_params(index, space) / space.total_params


def payload_bytes(index: GlobalIndex, space: UnitSpace, bytes_per_param: int = 4) -> float:
    """Communication payload of the sub-model (params + the index itself,
    4 bytes per unit id)."""
    index_bytes = sum(len(v) * 4 for v in index.values()) + 8
    return _retained_params(index, space) * bytes_per_param + index_bytes


def prune_to_budget(
    index: GlobalIndex,
    scores: Mapping[str, np.ndarray],
    pruned_rate: float,
    space: UnitSpace,
) -> GlobalIndex:
    """Cut the lowest-scored retained units until ``pruned_rate`` of the
    *current* model's parameters is removed (one global threshold across
    layers).  Ties break on ``(layer, unit)`` after the float64 score, so
    every worker and both packages remove the same units."""
    if not (0.0 <= pruned_rate < 1.0):
        raise ValueError(f"pruned_rate {pruned_rate} outside [0,1)")
    if pruned_rate == 0.0:
        return {k: v.copy() for k, v in index.items()}
    current = _retained_params(index, space)
    budget = pruned_rate * current
    entries: List[tuple] = []
    for l in space.layers:
        sc = np.asarray(scores[l.name], dtype=np.float64)
        if sc.shape[0] != l.num_units:
            raise ValueError(
                f"scores for {l.name} have {sc.shape[0]} entries, want {l.num_units}"
            )
        for u in index[l.name]:
            entries.append((sc[u], l.name, int(u), l.unit_param_cost))
    entries.sort(key=lambda e: (e[0], e[1], e[2]))
    removed: Dict[str, set] = {l.name: set() for l in space.layers}
    removed_params = 0
    n_retained = {l.name: len(index[l.name]) for l in space.layers}
    min_units = {l.name: l.min_units for l in space.layers}
    for score, lname, unit, cost in entries:
        if removed_params >= budget:
            break
        if n_retained[lname] <= min_units[lname]:
            continue
        removed[lname].add(unit)
        n_retained[lname] -= 1
        removed_params += cost
    return {
        l.name: np.array(
            [u for u in index[l.name] if int(u) not in removed[l.name]], dtype=np.int64
        )
        for l in space.layers
    }


def similarity(i1: GlobalIndex, i2: GlobalIndex) -> float:
    """Eq. 3: mean Jaccard similarity of retained units per layer."""
    keys = sorted(set(i1) | set(i2))
    vals = []
    for k in keys:
        a, b = set(map(int, i1.get(k, []))), set(map(int, i2.get(k, [])))
        union = a | b
        if not union:
            continue
        vals.append(len(a & b) / len(union))
    return float(np.mean(vals)) if vals else 1.0
