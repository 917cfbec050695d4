"""Server aggregation over the resident ``[W, ...]`` stacks (AdaptCL §III-B).

Port of the parts of ``repro/core/aggregation.py`` the resident masked
engine uses.  The stacks live on the device, so aggregation runs there, in
float64 like the reference's host aggregation (``aggregate_by_worker_stacked``
/ ``aggregate_by_unit_stacked``), and the result is cast to float32 by the
caller.  Rows are already masked (pruned coordinates exactly 0), so
by-worker aggregation is ``theta_g = sum_w c_w * stack_w`` and by-unit the
per-coordinate mean over the rows holding it.

``ROUNDTRIP_COUNTS`` counts ``extract_subparams`` calls (the reference's
host round-trip metric; the resident round loop makes none).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from .masks import GlobalIndex

__all__ = [
    "UnitMap",
    "ROUNDTRIP_COUNTS",
    "roundtrip_total",
    "extract_subparams",
    "subparam_shapes",
    "aggregate_by_worker_stacked",
    "aggregate_by_unit_stacked",
]

UnitMap = Mapping[str, Sequence[Tuple[str, int]]]
Params = Dict[str, torch.Tensor]

ROUNDTRIP_COUNTS: Dict[str, int] = {"extract_subparams": 0}


def roundtrip_total() -> int:
    return sum(ROUNDTRIP_COUNTS.values())


def extract_subparams(
    global_params: Params, index: GlobalIndex, unit_map: UnitMap
) -> Params:
    """theta_g ⊙ I_w: slice the sub-model out of the global model along
    every governed axis (physically smaller tensors)."""
    ROUNDTRIP_COUNTS["extract_subparams"] += 1
    out: Params = {}
    for path, arr in global_params.items():
        for lname, axis in unit_map.get(path, ()):
            idx = torch.as_tensor(np.asarray(index[lname], np.int64), device=arr.device)
            arr = torch.index_select(arr, axis, idx)
        out[path] = arr
    return out


def subparam_shapes(
    index: GlobalIndex, unit_map: UnitMap, base_shapes: Mapping[str, tuple]
) -> Dict[str, tuple]:
    """Reconfigured array shapes of a sub-model, without materializing it."""
    out: Dict[str, tuple] = {}
    for path, shape in base_shapes.items():
        s = list(shape)
        for lname, axis in unit_map.get(path, ()):
            s[axis] = len(index[lname])
        out[path] = tuple(s)
    return out


def aggregate_by_worker_stacked(
    param_stacks: Mapping[str, torch.Tensor],   # {path: [W, ...]} masked stacks
    weights: np.ndarray,                        # [W]; 0 for non-submitters
) -> Params:
    """By-worker aggregation off the stacks, float64: sum_w c_w * stack_w."""
    out: Params = {}
    for path, stack in param_stacks.items():
        wt = torch.as_tensor(np.asarray(weights, np.float64), device=stack.device)
        out[path] = torch.tensordot(wt, stack.double(), dims=1)
    return out


def aggregate_by_unit_stacked(
    param_stacks: Mapping[str, torch.Tensor],   # {path: [W, ...]} masked stacks
    mask_stacks: Mapping[str, torch.Tensor],    # {path: [W, ...]} 0/1 stacks
    submitters: np.ndarray,                     # [W] 0/1
) -> Params:
    """Per-coordinate mean over the submitting rows holding the coordinate,
    float64."""
    out: Params = {}
    for path, stack in param_stacks.items():
        sub = torch.as_tensor(np.asarray(submitters, np.float64), device=stack.device)
        num = torch.tensordot(sub, stack.double(), dims=1)
        den = torch.tensordot(sub, mask_stacks[path].double(), dims=1)
        out[path] = num / torch.clamp_min(den, 1.0)
    return out
