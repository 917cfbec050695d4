"""Global-index (I_w) machinery: unit space, budgeted pruning, similarity.

Port of the host parts of ``repro/core/masks.py`` (pure numpy, no device
work).  Worker w's sub-model is identified by its *global index* ``I_w`` —
for each prunable layer, the sorted ids of the retained units with respect
to the base model.  Each layer advertises a per-unit parameter cost so pruned
rates are enforced in parameter space (the paper's budget is a fraction of
model size).

FedDST regrowth works on a flat view of the unit space (``UnitFlat``): a
0/1 presence vector per worker, walked in a grow order (descending score,
``(layer, unit)`` tie-break) by ``regrow_index``.

**Device pruning** (the fused round engine, ``core.fused``): ``prune_order``
turns scores into ``prune_to_budget``'s exact removal order (float64,
``(score, layer, unit)`` tie-break), ``prune_budget_units`` turns the
float64 budget into the exact integer threshold of the greedy, and
``prune_presence_rows`` / ``regrow_presence_rows`` replay the greedy walks
over the ``[W, U]`` presence rows of the whole fleet on the device.  The
reference walks each row's order serially (a ``lax.scan`` over U); here the
walk is closed-form: along the order, a unit is removed iff it is retained,
fewer than ``count - min_units`` units of its layer came before it, and the
cost of the units removed before it is under the budget.  The removed cost
before a position is an exclusive prefix sum of the eligible costs, which is
non-decreasing, so "under the budget" holds on a prefix and the greedy's
early stop falls out of one comparison.  A few tensor ops per event instead
of a launch chain per unit; the sets are the walk's exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = [
    "GlobalIndex",
    "UnitLayer",
    "UnitSpace",
    "full_index",
    "retention",
    "payload_bytes",
    "prune_to_budget",
    "similarity",
    "UnitFlat",
    "flatten_unit_space",
    "presence_from_index",
    "index_from_presence",
    "grow_order",
    "regrow_index",
    "prune_order",
    "prune_budget_units",
    "prune_presence_rows",
    "regrow_presence_rows",
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


# ---------------------------------------------------------------------------
# flattened unit space + FedDST regrowth (host)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UnitFlat:
    """A :class:`UnitSpace` flattened into per-unit arrays.

    Unit ``j`` of layer ``names[l]`` lives at flat slot ``offsets[l] + j``.
    ``tiebreak[u]`` is the rank of slot ``u`` in ascending ``(layer_name,
    unit_id)`` order: the tie-break ``prune_to_budget`` applies between
    equal scores."""

    names: tuple                 # layer names, in space.layers order
    sizes: np.ndarray            # [L] units per layer
    offsets: np.ndarray          # [L] flat offset of each layer
    layer_of: np.ndarray         # [U] int32 layer id per flat slot
    unit_id: np.ndarray          # [U] int32 unit id within its layer
    costs: np.ndarray            # [U] int32 per-unit parameter cost
    min_units: np.ndarray        # [L] int32
    fixed_params: int
    tiebreak: np.ndarray         # [U] int32 (layer_name, unit) rank

    @property
    def num_units(self) -> int:
        return int(self.layer_of.shape[0])


def flatten_unit_space(space: UnitSpace) -> UnitFlat:
    names = tuple(l.name for l in space.layers)
    sizes = np.array([l.num_units for l in space.layers], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    layer_of = np.concatenate(
        [np.full(l.num_units, i, np.int32) for i, l in enumerate(space.layers)]
    )
    unit_id = np.concatenate([np.arange(l.num_units, dtype=np.int32) for l in space.layers])
    costs = np.concatenate(
        [np.full(l.num_units, l.unit_param_cost, np.int32) for l in space.layers]
    )
    min_units = np.array([l.min_units for l in space.layers], np.int32)
    # rank in ascending (layer_name, unit) order: the host sort's tie-break
    name_rank = np.argsort(np.argsort(np.array(names)))
    tiebreak = np.lexsort((unit_id, name_rank[layer_of]))
    rank = np.empty_like(tiebreak)
    rank[tiebreak] = np.arange(len(tiebreak))
    return UnitFlat(
        names=names, sizes=sizes, offsets=offsets, layer_of=layer_of,
        unit_id=unit_id, costs=costs, min_units=min_units,
        fixed_params=int(space.fixed_params), tiebreak=rank.astype(np.int32),
    )


def presence_from_index(index: GlobalIndex, flat: UnitFlat) -> np.ndarray:
    """[U] float32 0/1 flat presence vector of a global index."""
    p = np.zeros(flat.num_units, np.float32)
    for l, name in enumerate(flat.names):
        p[flat.offsets[l] + np.asarray(index[name], np.int64)] = 1.0
    return p


def index_from_presence(presence: np.ndarray, flat: UnitFlat) -> GlobalIndex:
    """Inverse of ``presence_from_index`` (retained slots, ascending)."""
    presence = np.asarray(presence)
    out: GlobalIndex = {}
    for l, name in enumerate(flat.names):
        seg = presence[flat.offsets[l] : flat.offsets[l] + flat.sizes[l]]
        out[name] = np.flatnonzero(seg > 0).astype(np.int64)
    return out


def grow_order(scores: Mapping[str, np.ndarray], flat: UnitFlat) -> np.ndarray:
    """[U] grow-order permutation: descending float64 score, ties broken by
    ascending ``(layer_name, unit)`` (a lexsort over the negated scores;
    negation is exact, so equal scores stay equal)."""
    flat_scores = np.concatenate([
        np.asarray(scores[name], np.float64)[: flat.sizes[l]]
        for l, name in enumerate(flat.names)
    ])
    if flat_scores.shape[0] != flat.num_units:
        raise ValueError("scores do not cover the unit space")
    return np.lexsort((flat.tiebreak, -flat_scores)).astype(np.int32)


def regrow_index(
    index: GlobalIndex,
    scores: Mapping[str, np.ndarray],
    budget_params: int,
    space: UnitSpace,
) -> GlobalIndex:
    """Add absent units in ``grow_order`` until ``budget_params`` parameters
    (an integer: the mass a preceding shrink removed) have come back; the
    mirror of ``prune_to_budget``'s greedy."""
    if budget_params <= 0:
        return {k: np.asarray(v, np.int64).copy() for k, v in index.items()}
    flat = flatten_unit_space(space)
    order = grow_order(scores, flat)
    present = presence_from_index(index, flat) > 0
    added = 0
    for u in order:
        if added >= budget_params:
            break
        u = int(u)
        if present[u]:
            continue
        present[u] = True
        added += int(flat.costs[u])
    return index_from_presence(present.astype(np.float32), flat)


# ---------------------------------------------------------------------------
# device pruning: host-exact orders and budgets, closed-form greedy walks
# ---------------------------------------------------------------------------

def prune_order(scores: Mapping[str, np.ndarray], flat: UnitFlat) -> np.ndarray:
    """[U] removal-order permutation of ``prune_to_budget``'s sort:
    ascending float64 score, ties broken by ``(layer_name, unit)``.  Slots a
    worker no longer retains are skipped by the walk, as the host loop never
    lists them."""
    flat_scores = np.concatenate([
        np.asarray(scores[name], np.float64)[: flat.sizes[l]]
        for l, name in enumerate(flat.names)
    ])
    if flat_scores.shape[0] != flat.num_units:
        raise ValueError("scores do not cover the unit space")
    return np.lexsort((flat.tiebreak, flat_scores)).astype(np.int32)


def prune_budget_units(index: GlobalIndex, rate: float, space: UnitSpace) -> int:
    """Exact integer removal threshold of one worker's prune event:
    ``removed < rate * current`` over integer costs equals ``removed <
    ceil(budget)`` (or ``< budget`` when it is integral), so no float32
    drift on the device can flip a removal."""
    budget = float(rate) * _retained_params(index, space)
    ceil_b = int(np.ceil(budget))
    return int(budget) if budget == np.floor(budget) else ceil_b


def _walk_tensors(flat: UnitFlat, device) -> Dict[str, torch.Tensor]:
    return {
        "layer_of": torch.as_tensor(flat.layer_of.astype(np.int64), device=device),
        "costs": torch.as_tensor(flat.costs.astype(np.int64), device=device),
        "min_units": torch.as_tensor(flat.min_units.astype(np.int64), device=device),
    }


def _exclusive_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(x, dim=dim) - x


def prune_presence_rows(
    presence: torch.Tensor,      # [W, U] float32 0/1
    orders: torch.Tensor,        # [W, U] int removal order per worker
    budgets: torch.Tensor,       # [W] int (prune_budget_units per worker)
    flat: UnitFlat,
    consts: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Device ``prune_to_budget`` over worker rows.  A slot is removed iff
    the budget is not yet met, its layer stays above ``min_units`` and the
    worker retains it; ``budgets == 0`` rows come back unchanged.  No host
    synchronisation.  ``consts`` caches ``flat``'s device arrays."""
    c = consts if consts is not None else _walk_tensors(flat, presence.device)
    orders = orders.long()
    L = len(flat.names)
    layer = c["layer_of"][orders]                                  # [W, U]
    present = torch.gather(presence, 1, orders) > 0                # [W, U]
    onehot = torch.nn.functional.one_hot(layer, L) * present.unsqueeze(-1).long()
    counts = onehot.sum(dim=1)                                     # [W, L]
    cap = counts - c["min_units"].unsqueeze(0)                     # removable per layer
    before = torch.gather(_exclusive_cumsum(onehot, 1), 2, layer.unsqueeze(-1)).squeeze(-1)
    eligible = present & (before < torch.gather(cap, 1, layer))
    cost = torch.where(eligible, c["costs"][orders], torch.zeros_like(layer))
    removed = eligible & (_exclusive_cumsum(cost, 1) < budgets.long().unsqueeze(1))
    out = presence.clone()
    out.scatter_(1, orders, torch.where(removed, 0.0, torch.gather(presence, 1, orders)))
    return out


def regrow_presence_rows(
    presence: torch.Tensor,      # [W, U] float32 0/1
    orders: torch.Tensor,        # [W, U] int grow order per worker
    budgets: torch.Tensor,       # [W] int parameter budgets to re-add
    flat: UnitFlat,
    consts: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Device ``regrow_index`` over worker rows: walking each grow order, a
    slot is added iff the budget is not yet met and the worker does not
    retain it; ``budgets == 0`` rows come back unchanged."""
    c = consts if consts is not None else _walk_tensors(flat, presence.device)
    orders = orders.long()
    absent = torch.gather(presence, 1, orders) == 0
    cost = torch.where(absent, c["costs"][orders], torch.zeros_like(orders))
    added = absent & (_exclusive_cumsum(cost, 1) < budgets.long().unsqueeze(1))
    out = presence.clone()
    out.scatter_(1, orders, torch.where(added, 1.0, torch.gather(presence, 1, orders)))
    return out
