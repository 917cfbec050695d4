"""Sparse training: group-lasso regularization (AdaptCL Eq. 1).

Port of ``repro/optim/group_lasso.py``.  The loss is
``CE + lambda * sum_g sqrt(|g|) * ||theta_g||_2`` where each group g is the
parameter slice owned by one prunable unit (a conv filter's kernel column +
BN gamma/beta + the consumer's input slice).  Groups follow the ``unit_map``
used for pruning and aggregation.

The tensor functions take ``batch_dims`` leading dimensions that are not
part of any group (the resident trainer passes its ``[B, ...]`` worker
stacks with ``batch_dims=1``); ``unit_map`` axes are per-worker axes.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "group_lasso_penalty",
    "unit_group_norms",
    "group_size_sqrt",
    "group_size_sqrt_from_shapes",
]

UnitMap = Mapping[str, Sequence[Tuple[str, int]]]


def unit_group_norms(
    params: Mapping[str, torch.Tensor], unit_map: UnitMap, batch_dims: int = 0
) -> Tuple[Dict[str, torch.Tensor], Dict[str, int]]:
    """Per-unit L2 norm aggregated across every array a unit touches, with
    the ``sqrt(max(., 1e-12))`` floor that sets the gradient at all-zero
    groups to 0.  Returns ``({layer: [*batch, units]}, {layer: group size})``."""
    sq: Dict[str, torch.Tensor] = {}
    size: Dict[str, int] = {}
    for path, entries in unit_map.items():
        arr = params.get(path)
        if arr is None:
            continue
        nd = arr.dim()
        for lname, axis in entries:
            ax = axis + batch_dims
            red = tuple(i for i in range(batch_dims, nd) if i != ax)
            s = torch.square(arr.float())
            if red:   # torch's sum over dim=() would reduce everything
                s = s.sum(dim=red)
            sq[lname] = s if lname not in sq else sq[lname] + s
            per = int(np.prod(arr.shape[batch_dims:]))
            size[lname] = size.get(lname, 0) + per // int(arr.shape[ax])
    return {k: torch.sqrt(torch.clamp_min(v, 1e-12)) for k, v in sq.items()}, size


def group_size_sqrt_from_shapes(
    shapes: Mapping[str, Sequence[int]], unit_map: UnitMap
) -> Dict[str, float]:
    """sqrt(|g|) per unit layer from (possibly reconfigured) shape tuples."""
    size: Dict[str, int] = {}
    for path, entries in unit_map.items():
        shape = shapes.get(path)
        if shape is None:
            continue
        n = int(np.prod(shape))
        for lname, axis in entries:
            size[lname] = size.get(lname, 0) + n // int(shape[axis])
    return {k: float(np.sqrt(v)) for k, v in size.items()}


def group_size_sqrt(params, unit_map: UnitMap) -> Dict[str, float]:
    """sqrt(|g|) per unit layer, from the arrays' shapes."""
    return group_size_sqrt_from_shapes(
        {path: tuple(arr.shape) for path, arr in params.items()}, unit_map
    )


def group_lasso_penalty(
    params: Mapping[str, torch.Tensor],
    unit_map: UnitMap,
    lam: float,
    size_sqrt: Optional[Mapping[str, torch.Tensor]] = None,
    batch_dims: int = 0,
) -> torch.Tensor:
    """``lambda * sum_g sqrt(|g|) ||theta_g||_2`` over prunable units, one
    value per batch row.  ``size_sqrt`` ({layer: [*batch]} or scalars)
    overrides the shape-derived factor, so a masked base-shape worker is
    penalised like its physically reconfigured twin."""
    norms, sizes = unit_group_norms(params, unit_map, batch_dims)
    total = None
    for lname, n in norms.items():
        if size_sqrt is not None:
            factor = size_sqrt[lname]
        else:
            factor = float(np.sqrt(float(sizes[lname])))
        term = factor * n.sum(dim=-1)
        total = term if total is None else total + term
    if total is None:
        raise ValueError("unit_map names no parameter of this model")
    return lam * total
