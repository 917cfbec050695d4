"""Server aggregation: By-worker vs By-unit (AdaptCL §III-B), and the
async servers' per-commit merges.

Port of ``repro/core/aggregation.py`` without the robust layer.  Two
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
none, the reconfiguring engines one per worker and phase.  The per-worker
async loop adds one ``async_merge`` per merged commit (``tally_roundtrip``).

``AsyncServer`` merges one commit at a time for fedasync_s, ssp_s and
dcasgd_s in host numpy float32, in the reference's own expression order, so
the same trained rows give bit-identical globals in both packages.

The fused round engine (``core.fused``) keeps the server on the device, in
float32 as the reference's fused engine does: ``aggregate_by_worker_stacked_dev``
and ``aggregate_by_unit_stacked_dev`` aggregate the stacks,
``dgc_compress_dev`` is ``simulation._dgc_compress_stacked`` with the keep
sets of the host compressor, and ``async_commit_dev`` is
``AsyncServer.commit`` for one commit.  None of them synchronises the host.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .masks import GlobalIndex

__all__ = [
    "UnitMap",
    "ROUNDTRIP_COUNTS",
    "roundtrip_total",
    "tally_roundtrip",
    "extract_subparams",
    "embed_params",
    "coordinate_mask",
    "subparam_shapes",
    "aggregate_by_worker",
    "aggregate_by_unit",
    "aggregate_by_worker_stacked",
    "aggregate_by_unit_stacked",
    "fedasync_weight",
    "AsyncServer",
    "aggregate_by_worker_stacked_dev",
    "aggregate_by_unit_stacked_dev",
    "dgc_compress_dev",
    "async_commit_dev",
]

UnitMap = Mapping[str, Sequence[Tuple[str, int]]]
Params = Dict[str, torch.Tensor]

ROUNDTRIP_COUNTS: Dict[str, int] = {"extract_subparams": 0, "embed_params": 0,
                                    "async_merge": 0}


def roundtrip_total() -> int:
    return sum(ROUNDTRIP_COUNTS.values())


def tally_roundtrip(kind: str, n: int = 1) -> None:
    """Count host round trips that do not go through extract/embed (the
    per-worker async loop's per-commit param-dict merges)."""
    ROUNDTRIP_COUNTS[kind] = ROUNDTRIP_COUNTS.get(kind, 0) + n


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


# ---------------------------------------------------------------------------
# async server merges (fedasync_s / ssp_s / dcasgd_s)
# ---------------------------------------------------------------------------

def fedasync_weight(a0: float, staleness: float) -> float:
    """Xie et al. polynomial staleness weighting: ``a0 * (s + 1)^-0.5``."""
    return float(a0 * (staleness + 1.0) ** -0.5)


class AsyncServer:
    """Per-commit server state of the asynchronous schedulers, host numpy.

    ``commit`` applies one worker's commit in base coordinates:

    * ``fedasync_s`` — ``theta <- (1-a) theta + a theta_w``,
      ``a = fedasync_weight(a0, s)``;
    * ``ssp_s``      — ``theta <- theta + (theta_w - fetched_w) / N``, N the
      committing cohort's size (``cohort_size``, default ``num_workers``);
    * ``dcasgd_s``   — DC-ASGD-a: the commit's "gradient" is the local update
      over lr, compensated by ``lam_t * g^2 * (theta - w_bak)`` with a
      mean-square-adaptive ``lam_t``.

    ``backup`` holds every slot's ``w_bak`` as a ``{path: [W, ...]}`` stack
    (slot ids index it even when only a cohort commits) and ``dc_m`` the
    running mean square.  ``commit`` rebinds ``params`` to a fresh dict and
    never writes an array in place, so callers may keep references to
    fetched snapshots."""

    def __init__(
        self,
        method: str,
        global_params: Mapping[str, np.ndarray],
        num_workers: int,
        *,
        cohort_size: Optional[int] = None,
        fedasync_a: float = 0.5,
        lr: float = 0.05,
        dcasgd_lambda: float = 2.0,
        dcasgd_m: float = 0.95,
    ):
        self.method = method
        self.params: Dict[str, np.ndarray] = dict(global_params)
        self.num_workers = num_workers
        self.cohort_size = num_workers if cohort_size is None else cohort_size
        self.version = 0
        self.fedasync_a = fedasync_a
        self.lr = lr
        self.dcasgd_lambda = dcasgd_lambda
        self.dcasgd_m = dcasgd_m
        self.backup: Optional[Dict[str, np.ndarray]] = None
        self.dc_m: Optional[Dict[str, np.ndarray]] = None
        if method == "dcasgd_s":
            self.backup = {
                k: np.repeat(np.asarray(v)[None], num_workers, axis=0)
                for k, v in global_params.items()
            }
            self.dc_m = {k: np.zeros_like(v) for k, v in global_params.items()}

    def commit(
        self, worker: int, trained: Mapping[str, np.ndarray],
        fetched: Mapping[str, np.ndarray], staleness: int,
    ) -> Dict[str, np.ndarray]:
        """Apply one worker's commit; returns (and rebinds) the new global."""
        g = self.params
        if self.method == "fedasync_s":
            a = fedasync_weight(self.fedasync_a, staleness)
            new = {k: (1 - a) * g[k] + a * trained[k] for k in g}
        elif self.method == "ssp_s":
            new = {k: g[k] + (trained[k] - fetched[k]) / self.cohort_size for k in g}
        elif self.method == "dcasgd_s":
            new = {}
            for k in g:
                grad = (fetched[k] - trained[k]) / self.lr
                self.dc_m[k] = self.dcasgd_m * self.dc_m[k] + (1 - self.dcasgd_m) * grad * grad
                lam_t = self.dcasgd_lambda / np.sqrt(np.mean(self.dc_m[k]) + 1e-12)
                comp = grad + lam_t * grad * grad * (g[k] - self.backup[k][worker])
                new[k] = g[k] - self.lr * comp
            for k in new:
                self.backup[k][worker] = new[k]
        else:
            raise ValueError(f"unknown async method {self.method!r}")
        self.params = new
        self.version += 1
        return new


# ---------------------------------------------------------------------------
# the server on the device (fused engine), float32
# ---------------------------------------------------------------------------

def aggregate_by_worker_stacked_dev(
    param_stacks: Mapping[str, torch.Tensor],   # {path: [W, ...]} masked stacks
    weights: torch.Tensor,                      # [W] float32; 0 for non-submitters
) -> Params:
    """By-worker aggregation in float32 on the stacks' device."""
    return {path: torch.tensordot(weights, stack, dims=1)
            for path, stack in param_stacks.items()}


def aggregate_by_unit_stacked_dev(
    param_stacks: Mapping[str, torch.Tensor],
    mask_stacks: Mapping[str, torch.Tensor],
    submitters: torch.Tensor,                   # [W] float32 0/1
) -> Params:
    """Per-coordinate mean over the submitting rows holding the coordinate,
    float32 on the device."""
    out: Params = {}
    for path, stack in param_stacks.items():
        num = torch.tensordot(submitters, stack, dims=1)
        den = torch.tensordot(submitters, mask_stacks[path], dims=1)
        out[path] = num / torch.clamp_min(den, 1.0)
    return out


def dgc_compress_dev(
    deltas: Mapping[str, torch.Tensor],      # {path: [W, ...]} param - global * mask
    residual: Mapping[str, torch.Tensor],    # {path: [W, ...]} carried residuals
    sparsity: float,
    masks: Optional[Mapping[str, torch.Tensor]],   # {path: [W, ...]} 0/1, or None
    rows: torch.Tensor,                      # [W] float 0/1 submitter gate
):
    """Top-|.| delta compression of the ``[W, ...]`` stacks on the device.

    Per tensor the accumulated delta (``delta + residual``) is viewed as
    ``[W, N]``; pruned coordinates drop to -1 so each row's keep budget
    counts its retained coordinates only; the row's ``n_keep``-th largest
    |value| is the threshold and ``>= thr`` keeps, ties included.  The keep
    budget is ``max(1, round(f32(size) * f32(1 - sparsity)))``, rounding half
    to even, as the host compressor computes it, so both keep the same sets.
    Rows with ``rows == 0`` commit nothing and keep their residual.  Returns
    ``(committed, new_residual, kept [W], total [W])``, the realized int32
    counts."""
    W = rows.shape[0]
    dev = rows.device
    kept = torch.zeros(W, dtype=torch.int32, device=dev)
    total = torch.zeros(W, dtype=torch.int32, device=dev)
    gate = rows > 0
    keep_frac = float(np.float32(1.0 - sparsity))
    committed: Params = {}
    new_res: Params = {}
    for k, d in deltas.items():
        flat = (d + residual[k]).reshape(W, -1)
        absf = flat.abs()
        if masks is not None:
            valid = masks[k].reshape(W, -1) > 0
            sizes = valid.sum(dim=1).to(torch.int32)
            absf = torch.where(valid, absf, torch.full_like(absf, -1.0))
        else:
            valid = None
            sizes = torch.full((W,), flat.shape[1], dtype=torch.int32, device=dev)
        n_keep = torch.clamp_min(torch.round(sizes.float() * keep_frac).to(torch.int32), 1)
        n_keep = torch.minimum(n_keep, torch.clamp_min(sizes, 1))
        desc = torch.sort(absf, dim=1, descending=True).values
        thr = torch.gather(desc, 1, (n_keep - 1).long().unsqueeze(1))
        keep = absf >= thr
        if valid is not None:
            keep = keep & valid
        zero = torch.zeros_like(flat)
        com = torch.where(keep, flat, zero)
        res = torch.where(keep, zero, flat)
        if valid is not None:
            res = torch.where(valid, res, zero)
        g = gate.unsqueeze(1)
        committed[k] = torch.where(g, com, zero).reshape(d.shape)
        new_res[k] = torch.where(g, res, residual[k].reshape(W, -1)).reshape(d.shape)
        kept = kept + torch.where(gate, keep.sum(dim=1).to(torch.int32), 0)
        total = total + torch.where(gate, sizes, 0)
    return committed, new_res, kept, total


def async_commit_dev(
    method: str,
    g: Mapping[str, torch.Tensor],           # global params
    trained: Mapping[str, torch.Tensor],     # the committing worker's trained params
    fetched_w: Mapping[str, torch.Tensor],   # the global it fetched before training
    staleness: torch.Tensor,                 # 0-d int
    backup_w: Mapping[str, torch.Tensor],    # dcasgd: its w_bak row ({} otherwise)
    dc_m: Mapping[str, torch.Tensor],        # dcasgd accumulator ({} otherwise)
    *,
    cohort_size: int,
    fedasync_a: float,
    lr: float,
    dcasgd_lambda: float,
    dcasgd_m: float,
):
    """``AsyncServer.commit`` for one commit, float32 on the device, the
    reference fused engine's expression order.  Ungated: the caller keeps
    or discards the result.  Returns ``(new global, new dc_m)``; under
    dcasgd_s the new global is also the worker's new ``w_bak`` row."""
    if method == "fedasync_s":
        a = fedasync_a * (staleness.float() + 1.0) ** -0.5
        return {k: (1 - a) * g[k] + a * trained[k] for k in g}, dict(dc_m)
    if method == "ssp_s":
        return {k: g[k] + (trained[k] - fetched_w[k]) / cohort_size for k in g}, dict(dc_m)
    if method == "dcasgd_s":
        new: Params = {}
        dc_m2: Params = {}
        for k in g:
            grad = (fetched_w[k] - trained[k]) / lr
            dc_m2[k] = dcasgd_m * dc_m[k] + (1 - dcasgd_m) * grad * grad
            lam_t = dcasgd_lambda / torch.sqrt(torch.mean(dc_m2[k]) + 1e-12)
            comp = grad + lam_t * grad * grad * (g[k] - backup_w[k])
            new[k] = g[k] - lr * comp
        return new, dc_m2
    raise ValueError(f"unknown async method {method!r}")
