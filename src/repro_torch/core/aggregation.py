"""Server aggregation: By-worker vs By-unit (AdaptCL §III-B).

Port of the synchronous parts of ``repro/core/aggregation.py``.  Two
representations, both aggregated in float64 like the reference's host
aggregation and cast to float32 by the caller:

* **per-worker lists** (``aggregate_by_worker`` / ``aggregate_by_unit``):
  the reconfigured engines' submissions, physically small params plus their
  global index, each embedded back into base coordinates (pruned positions
  exactly 0) with ``embed_params``;
* **resident stacks** (``aggregate_by_worker_stacked`` /
  ``aggregate_by_unit_stacked``): ``[W, ...]`` base-shape stacks whose rows
  are already masked, so by-worker is ``theta_g = sum_w c_w * stack_w`` and
  by-unit the per-coordinate mean over the rows holding it.

Both run on the params' device (the card, for a run there).
``ROUNDTRIP_COUNTS`` counts ``extract_subparams`` and ``embed_params``
calls, the reference's host round-trip metric: the resident round loop makes
none, the reconfiguring engines one per worker and phase.
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
    "embed_params",
    "coordinate_mask",
    "subparam_shapes",
    "aggregate_by_worker",
    "aggregate_by_unit",
    "aggregate_by_worker_stacked",
    "aggregate_by_unit_stacked",
]

UnitMap = Mapping[str, Sequence[Tuple[str, int]]]
Params = Dict[str, torch.Tensor]

ROUNDTRIP_COUNTS: Dict[str, int] = {"extract_subparams": 0, "embed_params": 0}


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


def embed_params(
    sub_params: Params, index: GlobalIndex, unit_map: UnitMap,
    base_shapes: Mapping[str, tuple],
) -> Params:
    """Zero-fill sub-model params into base coordinates."""
    ROUNDTRIP_COUNTS["embed_params"] += 1
    out: Params = {}
    for path, arr in sub_params.items():
        for lname, axis in unit_map.get(path, ()):
            if arr.shape[axis] != len(index[lname]):
                raise ValueError(f"{path}: {arr.shape[axis]} units along axis {axis}, "
                                 f"index {lname!r} has {len(index[lname])}")
            shape = list(arr.shape)
            shape[axis] = base_shapes[path][axis]
            idx = torch.as_tensor(np.asarray(index[lname], np.int64), device=arr.device)
            arr = torch.zeros(shape, dtype=arr.dtype, device=arr.device).index_copy(axis, idx, arr)
        if tuple(arr.shape) != tuple(base_shapes[path]):
            raise ValueError(f"{path}: embedded {tuple(arr.shape)} != base {tuple(base_shapes[path])}")
        out[path] = arr
    return out


def coordinate_mask(
    path: str, index: GlobalIndex, unit_map: UnitMap, base_shapes: Mapping[str, tuple]
) -> np.ndarray:
    """float64 1.0 where the worker retains the coordinate, else 0.0."""
    shape = base_shapes[path]
    mask = np.ones(shape, dtype=np.float64)
    for lname, axis in unit_map.get(path, ()):
        axis_mask = np.zeros(shape[axis], dtype=np.float64)
        axis_mask[np.asarray(index[lname], dtype=np.int64)] = 1.0
        bshape = [1] * len(shape)
        bshape[axis] = shape[axis]
        mask = mask * axis_mask.reshape(bshape)
    return mask


def aggregate_by_worker(
    submissions: Sequence[Tuple[Params, GlobalIndex]],
    unit_map: UnitMap,
    base_shapes: Mapping[str, tuple],
) -> Params:
    """theta_g = sum_w embed(theta_w) / W, float64, summed in worker order."""
    weight = 1.0 / len(submissions)
    out: Params = {}
    for sub, idx in submissions:
        for path, arr in embed_params(sub, idx, unit_map, base_shapes).items():
            contrib = weight * arr.double()
            out[path] = contrib if path not in out else out[path] + contrib
    return out


def aggregate_by_unit(
    submissions: Sequence[Tuple[Params, GlobalIndex]],
    unit_map: UnitMap,
    base_shapes: Mapping[str, tuple],
) -> Params:
    """Per-coordinate 1/w' averaging over the holders of each coordinate,
    float64."""
    num: Params = {}
    den: Dict[str, np.ndarray] = {}
    for sub, idx in submissions:
        for path, arr in embed_params(sub, idx, unit_map, base_shapes).items():
            m = coordinate_mask(path, idx, unit_map, base_shapes)
            num[path] = arr.double() if path not in num else num[path] + arr.double()
            den[path] = m if path not in den else den[path] + m
    return {
        p: num[p] / torch.as_tensor(np.maximum(den[p], 1.0), device=num[p].device)
        for p in num
    }


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
