"""Server aggregation: By-worker vs By-unit (AdaptCL §III-B), and the
async servers' per-commit merges.

Port of ``repro/core/aggregation.py``.  Two representations, both
aggregated in float64 like the reference's host aggregation and cast to
float32 by the caller:

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

**The robust layer** (``SimConfig.robust``, ``RobustAggConfig``) defends
the by-worker server against the byzantine and lossy-channel fault
families.  ``robust_submission_step_dev`` is one server round at the
submission boundary, shared by every sync engine as in the reference: the
byzantine transform and the channel's payload corruption (noise from
``core.prng``, the reference's own threefry stream), the pre-clip delta
norms, the MAD-outlier quarantine (``health_step_dev``), the L2 norm clip,
then the plain weighted mean or the presence-aware coordinate-wise trimmed
mean (``trimmed_mean_stacked_dev``).  Float32 on the stacks' device, free
of host synchronisation, so the fused chunk runs it in place; the rows to
garble are host flags (each flagged row's noise is drawn alone, at its own
counters).  The async servers take the clip and the quarantine per commit
(``AsyncServer`` on the host, ``async_commit_dev`` and
``async_health_step_dev`` in the fused chunk).

**The mesh-sharded fleet** (``SimConfig.mesh``) passes ``mesh=`` to the
device server: each rank aggregates its own rows and the ranks meet in
``sharding.collectives`` — the two-tier sums close with ``psum_fleet``,
the trimmed mean and the health step all-gather the fleet's votes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sharding.collectives import all_gather_fleet, psum_fleet, shard_row_slice

from . import prng
from .masks import GlobalIndex

__all__ = [
    "QuarantineConfig",
    "RobustAggConfig",
    "noise_key",
    "byzantine_transform_dev",
    "corrupt_transform_dev",
    "delta_norms_dev",
    "clip_deltas_dev",
    "health_step_dev",
    "async_health_step_dev",
    "trimmed_mean_stacked_dev",
    "robust_aggregate_stacked_dev",
    "robust_submission_step_dev",
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
    fetched snapshots.

    The robust layer's async half: ``clip_norm`` L2-clips the commit's
    delta (``trained - fetched``, float64) before the merge, and
    ``quarantine`` runs the per-commit MAD-outlier tracker over each slot's
    last commit norm (float32, the fused engine's twin); a rejected commit
    is discarded but still bumps the version, which the event plan fixed,
    and counts in ``rejected_commits``."""

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
        clip_norm: Optional[float] = None,
        quarantine: Optional["QuarantineConfig"] = None,
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
        self.clip_norm = clip_norm
        self.quarantine = quarantine
        self.strikes = np.zeros(num_workers, dtype=np.int32)
        self.quar_left = np.zeros(num_workers, dtype=np.int32)
        self.last_norms = np.zeros(num_workers, dtype=np.float32)
        self.seen = np.zeros(num_workers, dtype=bool)
        self.rejected_commits = 0

    @staticmethod
    def _delta_norm(delta: Mapping[str, np.ndarray]) -> np.float32:
        """Float32 ``delta_norms_dev`` of one worker's delta dict."""
        tot = np.float32(0.0)
        for k in sorted(delta):
            d = np.asarray(delta[k], np.float32).ravel()
            tot = np.float32(tot + np.float32(np.sum(d * d, dtype=np.float32)))
        return np.float32(np.sqrt(tot))

    def _health_step(self, norm: np.float32, worker: int) -> bool:
        """Host ``async_health_step_dev``: returns whether to reject."""
        q = self.quarantine
        self.last_norms[worker] = norm
        self.seen[worker] = True
        quar_now = bool(self.quar_left[worker] > 0)
        n = int(self.seen.sum())
        x = np.where(self.seen, self.last_norms, np.inf).astype(np.float32)
        med = np.sort(x)[max(n - 1, 0) // 2]
        dev = np.where(self.seen, np.abs(self.last_norms - med), np.inf).astype(np.float32)
        mad = np.sort(dev)[max(n - 1, 0) // 2]
        floor = np.maximum(mad, np.float32(1e-6 * abs(med) + 1e-12))
        outlier = bool(abs(norm - med) > np.float32(q.threshold) * floor)
        s_w = self.strikes[worker] + 1 if (outlier and not quar_now) else 0
        enter = (not quar_now) and s_w >= q.strikes
        self.strikes[worker] = 0 if enter else s_w
        self.quar_left[worker] = q.probation if enter else max(self.quar_left[worker] - 1, 0)
        return quar_now or enter

    def commit(
        self, worker: int, trained: Mapping[str, np.ndarray],
        fetched: Mapping[str, np.ndarray], staleness: int,
    ) -> Dict[str, np.ndarray]:
        """Apply one worker's commit; returns (and rebinds) the new global."""
        if self.clip_norm is not None or self.quarantine is not None:
            delta = {k: np.asarray(trained[k], np.float64) - np.asarray(fetched[k], np.float64)
                     for k in trained}
            norm = self._delta_norm(delta)
            if self.quarantine is not None and self._health_step(norm, worker):
                self.rejected_commits += 1
                self.version += 1
                return self.params
            if self.clip_norm is not None:
                scale = float(np.minimum(
                    np.float32(1.0),
                    np.float32(self.clip_norm) / np.maximum(norm, np.float32(1e-30)),
                ))
                trained = {k: np.asarray(fetched[k], np.float64) + delta[k] * scale
                           for k in trained}
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
    mesh=None,
) -> Params:
    """By-worker aggregation in float32 on the stacks' device.  With a
    ``mesh`` the stacks are this rank's rows: the local weighted sum is the
    regional tier, and ``psum_fleet`` over the fleet axis the global one."""
    out = {path: torch.tensordot(weights, stack, dims=1)
           for path, stack in param_stacks.items()}
    return out if mesh is None else psum_fleet(out, mesh)


def aggregate_by_unit_stacked_dev(
    param_stacks: Mapping[str, torch.Tensor],
    mask_stacks: Mapping[str, torch.Tensor],
    submitters: torch.Tensor,                   # [W] float32 0/1
    mesh=None,
) -> Params:
    """Per-coordinate mean over the submitting rows holding the coordinate,
    float32 on the device.  With a ``mesh`` the numerator and the holder
    count each sum over the fleet axis before the division, so each
    coordinate is divided by the fleet's holder count, not the rank's."""
    num = {path: torch.tensordot(submitters, stack, dims=1)
           for path, stack in param_stacks.items()}
    den = {path: torch.tensordot(submitters, mask_stacks[path], dims=1) for path in num}
    if mesh is not None:
        both = psum_fleet({**{("num", k): v for k, v in num.items()},
                           **{("den", k): v for k, v in den.items()}}, mesh)
        num = {k: both[("num", k)] for k in num}
        den = {k: both[("den", k)] for k in den}
    return {path: num[path] / torch.clamp_min(den[path], 1.0) for path in num}


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
    clip_norm: Optional[float] = None,
):
    """``AsyncServer.commit`` for one commit, float32 on the device, the
    reference fused engine's expression order.  Ungated: the caller keeps
    or discards the result.  Returns ``(new global, new dc_m)``; under
    dcasgd_s the new global is also the worker's new ``w_bak`` row.
    ``clip_norm`` L2-clips the commit's delta ``trained - fetched_w``
    before the merge."""
    if clip_norm is not None:
        delta = {k: trained[k] - fetched_w[k] for k in trained}
        norm = delta_norms_dev({k: d.unsqueeze(0) for k, d in delta.items()})[0]
        scale = torch.clamp_max(_over(clip_norm, torch.clamp_min(norm, 1e-30)), 1.0)
        trained = {k: fetched_w[k] + delta[k] * scale for k in trained}
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


# ---------------------------------------------------------------------------
# the robust aggregation layer (clip / trimmed mean / quarantine)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuarantineConfig:
    """Server-side health tracker: quarantine repeated MAD-outlier workers.

    Each aggregated round the server takes the median and the median
    absolute deviation (MAD) of the eligible submitters' pre-clip update
    norms; a worker whose norm deviates more than ``threshold`` MADs strikes
    (a clean round resets its strikes).  ``strikes`` consecutive strikes
    quarantine it for ``probation`` aggregated rounds: its commits are
    excluded from aggregation (it still trains, and its phi still gates the
    round clock), then it is readmitted with a clean record."""

    threshold: float = 3.0  # MAD multiples before a norm counts as an outlier
    strikes: int = 2        # consecutive outlier rounds before quarantine
    probation: int = 3      # aggregated rounds excluded once quarantined

    def __post_init__(self):
        if not (self.threshold > 0.0):
            raise ValueError(f"quarantine threshold {self.threshold} must be > 0")
        if self.strikes < 1:
            raise ValueError(f"quarantine strikes {self.strikes} must be >= 1")
        if self.probation < 1:
            raise ValueError(f"quarantine probation {self.probation} must be >= 1")


@dataclasses.dataclass(frozen=True)
class RobustAggConfig:
    """The robust server aggregation layer (``SimConfig.robust``).

    ``clip`` bounds each commit's L2 delta norm (None = no clipping);
    ``trim`` is the per-end coordinate-wise trimmed-mean fraction (0 = the
    plain weighted mean, by a static branch); ``quarantine`` enables the
    MAD-outlier health tracker.  ``RobustAggConfig()`` is a no-op."""

    clip: Optional[float] = None
    trim: float = 0.0
    quarantine: Optional[QuarantineConfig] = None

    def __post_init__(self):
        if self.clip is not None and not (self.clip > 0.0):
            raise ValueError(f"robust clip {self.clip} must be > 0")
        if not (0.0 <= self.trim < 0.5):
            raise ValueError(f"robust trim {self.trim} outside [0, 0.5)")

    @property
    def any_active(self) -> bool:
        return self.clip is not None or self.trim > 0.0 or self.quarantine is not None


def _f32(x: float) -> float:
    """A Python constant as the float32 value the reference computes with."""
    return float(np.float32(x))


def _over(c: float, t: torch.Tensor) -> torch.Tensor:
    """``float32(c) / t`` as a true division (torch's ``scalar / tensor`` is
    a reciprocal times the scalar, which rounds differently)."""
    return torch.full_like(t, _f32(c)) / t


def _row_bcast(row: torch.Tensor, ndim: int) -> torch.Tensor:
    return row.reshape((row.shape[0],) + (1,) * (ndim - 1))


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` for a 0-d index tensor, without reading it on the host."""
    return t.index_select(0, idx.reshape(1))[0]


def noise_key(seed: int, round_t: int) -> prng.Key:
    """Per-round noise key of the byzantine and corruption garbling:
    ``fold_in(PRNGKey(seed), round_t)``, a host key (``core.prng``)."""
    return prng.fold_in(prng.prng_key(seed), round_t)


def _leaf_noise(key: prng.Key, leaf_idx: int, shape, device, offset: int = 0) -> torch.Tensor:
    return prng.normal(prng.fold_in(key, leaf_idx), shape, offset, device)


def _stack_noise(key: prng.Key, leaf_idx: int, leaf: torch.Tensor, full_rows: Optional[int],
                 row_offset: Optional[int], rows: Optional[Sequence[int]] = None
                 ) -> torch.Tensor:
    """Noise rows for ``leaf`` (``[W_local, ...]``), drawn at full fleet
    width: local row ``r`` takes the counters of global row ``row_offset +
    r`` of a ``[full_rows, ...]`` draw, so every mesh size sees the same
    noise per global slot.  ``rows`` (local row ids, host ints) draws only
    those rows, stacked in that order; the default draws all of them."""
    n_loc = leaf.shape[0]
    total = n_loc if full_rows is None else full_rows
    off = 0 if row_offset is None else int(row_offset)
    if off + n_loc > total:
        raise ValueError(f"rows {off}..{off + n_loc} outside a {total}-row fleet")
    rows = range(n_loc) if rows is None else rows
    per_row = int(np.prod(leaf.shape[1:]))
    return torch.stack([
        _leaf_noise(key, leaf_idx, tuple(leaf.shape[1:]), leaf.device, (off + r) * per_row)
        for r in rows
    ]) if len(rows) else leaf.new_zeros((0,) + tuple(leaf.shape[1:]))


def _garble_rows(deltas: Mapping[str, torch.Tensor], masks, flagged, fn) -> Params:
    """Rewrite the flagged rows (host bool ``[W]``) of every leaf, in sorted
    key order: row ``r`` becomes ``fn(i, k, r, delta[r])``, times its mask
    row.  Unflagged rows pass through bit-untouched, and a stack with no
    flagged row is returned as it is."""
    rows = [int(r) for r in np.flatnonzero(np.asarray(flagged, bool))]
    out: Params = {}
    for i, k in enumerate(sorted(deltas)):
        d = deltas[k]
        if not rows:
            out[k] = d
            continue
        new = d.clone()
        for r in rows:
            bad = fn(i, k, r, d[r])
            new[r] = bad * masks[k][r] if masks is not None else bad
        out[k] = new
    return out


def byzantine_transform_dev(
    deltas: Mapping[str, torch.Tensor],           # {path: [W, ...]} committed deltas
    masks: Optional[Mapping[str, torch.Tensor]],  # {path: [W, ...]} 0/1, or None
    byz_row,                                      # host bool [W]: compromised this round
    *,
    mode: str,
    scale: float,
    noise_std: float,
    key: Optional[prng.Key],
    full_rows: Optional[int] = None,
    row_offset: Optional[int] = None,
) -> Params:
    """The byzantine attack on the compromised rows of a delta stack:
    ``sign_flip`` sends ``-delta``, ``scale`` sends ``scale * delta``,
    ``noise`` sends ``delta + noise_std * N(0, 1)`` (leaf ``i``'s noise
    from ``fold_in(key, i)``).  Attacked rows are masked back to their live
    coordinates; honest rows pass through bit-untouched."""
    std, sc = _f32(noise_std), _f32(scale)

    def attack(i, k, r, d):
        if mode == "sign_flip":
            return -d
        if mode == "scale":
            return sc * d
        noise = _stack_noise(key, i, deltas[k], full_rows, row_offset, [r])[0]
        return d + std * noise

    return _garble_rows(deltas, masks, byz_row, attack)


def corrupt_transform_dev(
    deltas: Mapping[str, torch.Tensor],
    masks: Optional[Mapping[str, torch.Tensor]],
    corrupt_row,                                  # host bool [W]: payload garbled
    *,
    corrupt_std: float,
    key: Optional[prng.Key],
    full_rows: Optional[int] = None,
    row_offset: Optional[int] = None,
) -> Params:
    """The lossy channel's payload corruption: ``delta + corrupt_std * N``
    on the corrupted rows, masked to their live coordinates.  Leaf ``i``
    draws from ``fold_in(key, 1000 + i)``, away from the attack stream."""
    std = _f32(corrupt_std)

    def garble(i, k, r, d):
        return d + std * _stack_noise(key, 1000 + i, deltas[k], full_rows, row_offset, [r])[0]

    return _garble_rows(deltas, masks, corrupt_row, garble)


def delta_norms_dev(deltas: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Per-row L2 norm of a delta stack over all leaves, ``[W]`` float32;
    leaves add up in sorted-key order, as in the reference."""
    total = None
    for k in sorted(deltas):
        d = deltas[k].float()
        sq = (d.reshape(d.shape[0], -1) ** 2).sum(dim=1)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_deltas_dev(deltas: Mapping[str, torch.Tensor], norms: torch.Tensor,
                    clip: float) -> Params:
    """Per-commit L2 clipping: rows with ``norm > clip`` are scaled onto the
    clip sphere; the others are multiplied by exactly 1.0."""
    scale = torch.clamp_max(_over(clip, torch.clamp_min(norms, 1e-30)), 1.0)
    return {k: d * _row_bcast(scale.to(d.dtype), d.dim()) for k, d in deltas.items()}


def _lower_median(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """The lower median of the ``n`` finite entries of ``x`` (the rest
    +inf): ``sort(x)[(max(n, 1) - 1) // 2]``, indexed on the device."""
    return _take(torch.sort(x).values, torch.div(torch.clamp_min(n - 1, 0), 2,
                                                 rounding_mode="floor"))


def health_step_dev(
    norms: torch.Tensor,      # [W] float32: this round's update norms
    eligible: torch.Tensor,   # [W] bool: submitted and delivered this round
    strikes: torch.Tensor,    # [W] int32 carry
    quar_left: torch.Tensor,  # [W] int32 carry: probation rounds remaining
    *,
    threshold: float,
    strikes_needed: int,
    probation: int,
    gate: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One aggregated round of the MAD-outlier health tracker.

    Returns ``(quar_now, strikes', quar_left')``, ``quar_now`` the rows
    quarantined at the round's start (excluded from its aggregation).
    Median and MAD are lower medians over the eligible, non-quarantined rows;
    the MAD floor ``max(MAD, 1e-6 |median| + 1e-12)`` keeps an all-identical
    honest cohort from flagging on float32 dust.  ``gate=False`` (a dead
    round) leaves the carries as they were."""
    quar_now = quar_left > 0
    elig = eligible & ~quar_now
    n = elig.sum()
    inf = torch.full_like(norms, float("inf"))
    med = _lower_median(torch.where(elig, norms, inf), n)
    dev_abs = (norms - med).abs()
    mad = _lower_median(torch.where(elig, dev_abs, inf), n)
    floor = torch.maximum(mad, 1e-6 * med.abs() + 1e-12)
    outlier = elig & (dev_abs > _f32(threshold) * floor) & (n > 0)
    zero = torch.zeros_like(strikes)
    strikes2 = torch.where(elig, torch.where(outlier, strikes + 1, zero), strikes)
    enter = elig & (strikes2 >= strikes_needed)
    quar2 = torch.where(enter, torch.full_like(quar_left, probation),
                        torch.clamp_min(quar_left - 1, 0))
    strikes2 = torch.where(enter, zero, strikes2)
    if gate is not None and not gate:
        return quar_now, strikes, quar_left
    return quar_now, strikes2, quar2


def async_health_step_dev(
    norm: torch.Tensor,        # 0-d float32: this commit's update norm
    worker: torch.Tensor,      # 0-d int64 slot id
    strikes: torch.Tensor,     # [W] int32 carry
    quar_left: torch.Tensor,   # [W] int32 carry
    last_norms: torch.Tensor,  # [W] float32 carry: last commit norm per slot
    seen: torch.Tensor,        # [W] bool carry: the slot has committed before
    *,
    threshold: float,
    strikes_needed: int,
    probation: int,
):
    """The per-commit health step of the fused async engine (the device
    twin of ``AsyncServer._health_step``): the median and MAD run over each
    slot's last commit norm.  Returns ``(reject, strikes', quar_left',
    last_norms', seen')``; ``reject`` marks a commit from a quarantined slot
    (its probation counts down per rejected commit) or the commit that
    triggers quarantine."""
    w = worker.reshape(1)
    norms2 = last_norms.index_copy(0, w, norm.reshape(1))
    seen2 = seen.index_fill(0, w, True)
    q_w = _take(quar_left, worker)
    quar_now = q_w > 0
    n = seen2.sum()
    inf = torch.full_like(norms2, float("inf"))
    med = _lower_median(torch.where(seen2, norms2, inf), n)
    mad = _lower_median(torch.where(seen2, (norms2 - med).abs(), inf), n)
    floor = torch.maximum(mad, 1e-6 * med.abs() + 1e-12)
    outlier = (norm - med).abs() > _f32(threshold) * floor
    s_w = torch.where(outlier & ~quar_now, _take(strikes, worker) + 1,
                      torch.zeros((), dtype=strikes.dtype, device=strikes.device))
    enter = ~quar_now & (s_w >= strikes_needed)
    strikes2 = strikes.index_copy(0, w, torch.where(enter, torch.zeros_like(s_w), s_w)
                                  .reshape(1).to(strikes.dtype))
    quar2 = quar_left.index_copy(0, w, torch.where(
        enter, torch.full_like(q_w, probation), torch.clamp_min(q_w - 1, 0))
        .reshape(1).to(quar_left.dtype))
    return quar_now | enter, strikes2, quar2, norms2, seen2


def trimmed_mean_stacked_dev(
    param_stacks: Mapping[str, torch.Tensor],            # {path: [W, ...]} masked stacks
    mask_stacks: Optional[Mapping[str, torch.Tensor]],   # presence, or None
    eligible: torch.Tensor,                              # [W] bool: votes counted
    trim: float,
) -> Params:
    """Coordinate-wise trimmed mean over a stack, presence-aware.

    Per coordinate only holder votes (eligible rows whose mask keeps it)
    enter the order statistics; ``k = floor(f32(trim) * n_c)`` votes drop
    from each end of the ``n_c`` holder votes, the survivors are averaged
    and rescaled by ``n_c / |eligible|`` (the zero-vote shrinkage of
    by-worker averaging)."""
    elig_n = torch.clamp_min(eligible.sum().float(), 1.0)
    W = eligible.shape[0]
    ranks = torch.arange(W, device=eligible.device)
    out: Params = {}
    for k in sorted(param_stacks):
        stack = param_stacks[k].float()
        valid = _row_bcast(eligible, stack.dim())
        if mask_stacks is not None:
            valid = valid & (mask_stacks[k] > 0)
        else:
            valid = valid.expand(stack.shape)
        n_c = valid.sum(dim=0)
        k_c = torch.floor(_f32(trim) * n_c.float()).to(n_c.dtype)
        xs = torch.sort(torch.where(valid, stack, torch.full_like(stack, float("inf"))),
                        dim=0).values
        r = ranks.reshape((W,) + (1,) * (stack.dim() - 1))
        keep = (r >= k_c) & (r < n_c - k_c)
        kept_sum = torch.where(keep, xs, torch.zeros_like(xs)).sum(dim=0)
        keep_n = torch.clamp_min(n_c - 2 * k_c, 1).float()
        est = kept_sum * n_c.float() / (keep_n * elig_n)
        out[k] = torch.where(n_c > 0, est, torch.zeros_like(est))
    return out


def robust_aggregate_stacked_dev(
    param_stacks: Mapping[str, torch.Tensor],
    weights: torch.Tensor,                               # [W] float32 multiplicities
    mask_stacks: Optional[Mapping[str, torch.Tensor]] = None,
    *,
    trim: float = 0.0,
    mesh=None,
) -> Params:
    """The robust server's aggregation step.  ``trim == 0`` is
    ``aggregate_by_worker_stacked_dev`` itself; ``trim > 0`` the trimmed
    mean, where only ``weights > 0`` counts (a duplicated delivery is one
    vote).  With a ``mesh`` the trimmed mean all-gathers every rank's rows,
    masks and weights first (an order statistic needs every vote) and runs
    on the whole fleet, replicated."""
    if trim == 0.0:
        return aggregate_by_worker_stacked_dev(param_stacks, weights, mesh)
    if mesh is not None:
        param_stacks, mask_stacks, weights = _gather_votes(param_stacks, mask_stacks, weights,
                                                           mesh)
    return trimmed_mean_stacked_dev(param_stacks, mask_stacks, weights > 0, trim)


def _gather_votes(stacks, masks, weights, mesh):
    """Every rank's rows of the stacks, masks (or None) and ``[W_local]``
    weights, as full-fleet tensors, in one gather."""
    tree = {("p", k): v for k, v in stacks.items()}
    if masks is not None:
        tree.update({("m", k): masks[k] for k in stacks})
    tree["w"] = weights
    full = all_gather_fleet(tree, mesh)
    return ({k: full[("p", k)] for k in stacks},
            None if masks is None else {k: full[("m", k)] for k in stacks}, full["w"])


def robust_submission_step_dev(
    param_stacks: Mapping[str, torch.Tensor],   # {path: [W, ...]} committed rows
    mask_stacks: Optional[Mapping[str, torch.Tensor]],
    global_p: Mapping[str, torch.Tensor],       # {path: [...]} current global
    mult: torch.Tensor,                         # [W] float32 multiplicity weights
    weights: torch.Tensor,                      # [W] float32 normalized weights
    byz_row,                                    # host bool [W], or None
    corrupt_row,                                # host bool [W], or None
    byz_key: Optional[prng.Key],
    corrupt_key: Optional[prng.Key],
    strikes: Optional[torch.Tensor],            # [W] int32 carry (the whole fleet's)
    quar_left: Optional[torch.Tensor],          # [W] int32 carry (the whole fleet's)
    *,
    byz_mode: str = "sign_flip",
    byz_scale: float = -10.0,
    byz_noise_std: float = 1.0,
    corrupt_std: float = 10.0,
    clip: Optional[float] = None,
    trim: float = 0.0,
    quarantine: Optional[QuarantineConfig] = None,
    gate: Optional[bool] = None,
    full_rows: Optional[int] = None,
    row_offset: Optional[int] = None,
    mesh=None,
):
    """One server round at the submission boundary: attack, defense,
    aggregate, in the reference's fixed order — byzantine transform, channel
    corruption, pre-clip norms, health quarantine, norm clip, then the plain
    weighted mean or the trimmed mean.

    ``mult`` is the channel multiplicity (submit x delivered x (1 + dup))
    and decides eligibility; ``weights`` is the normalized plain-mean vector
    used when no quarantine reweights.  Returns ``(new global, strikes',
    quar_left', quar_now)``; the health carries pass through when
    ``quarantine`` is None.  A round with no delivered weight keeps the
    global.

    With a ``mesh`` the stacks, ``mult``, ``weights`` and the row flags are
    this rank's ``W_local`` rows, global slots from ``row_offset`` (default
    ``rank x W_local``) of a ``full_rows``-row fleet, so each row draws its
    global slot's noise.  The health step runs on the all-gathered norms and
    multiplicities, replicated over full-fleet ``[W]`` carries; the fleet
    weight vector is sliced back to this rank's rows, and ``wsum`` and the
    mean close with ``psum_fleet``."""
    stacks = {k: v.float() for k, v in param_stacks.items()}
    masks = mask_stacks
    w_local = mult.shape[0]
    if mesh is not None and row_offset is None:
        row_offset = mesh.rank * w_local
    norms = None
    if byz_row is not None or corrupt_row is not None or clip is not None \
            or quarantine is not None:
        if masks is not None:
            bcast = {k: global_p[k].unsqueeze(0) * masks[k] for k in stacks}
        else:
            bcast = {k: global_p[k].unsqueeze(0).expand(stacks[k].shape) for k in stacks}
        deltas = {k: stacks[k] - bcast[k] for k in stacks}
        if byz_row is not None:
            deltas = byzantine_transform_dev(
                deltas, masks, byz_row, mode=byz_mode, scale=byz_scale,
                noise_std=byz_noise_std, key=byz_key, full_rows=full_rows,
                row_offset=row_offset)
        if corrupt_row is not None:
            deltas = corrupt_transform_dev(
                deltas, masks, corrupt_row, corrupt_std=corrupt_std, key=corrupt_key,
                full_rows=full_rows, row_offset=row_offset)
        if clip is not None or quarantine is not None:
            norms = delta_norms_dev(deltas)
        if clip is not None:
            deltas = clip_deltas_dev(deltas, norms, clip)
        stacks = {k: bcast[k] + deltas[k] for k in stacks}
    quar_now = None
    strikes2, quar2 = strikes, quar_left
    if quarantine is not None:
        if mesh is not None:
            full = all_gather_fleet({"norms": norms, "mult": mult}, mesh)
            norms_full, mult_full = full["norms"], full["mult"]
        else:
            norms_full, mult_full = norms, mult
        quar_now, strikes2, quar2 = health_step_dev(
            norms_full, mult_full > 0, strikes, quar_left, threshold=quarantine.threshold,
            strikes_needed=quarantine.strikes, probation=quarantine.probation, gate=gate)
        w_full = mult_full * (1.0 - quar_now.float())
        wsum = w_full.sum()
        if trim > 0.0:
            if mesh is not None:
                stacks_g, masks_g, _ = _gather_votes(stacks, masks, mult, mesh)
            else:
                stacks_g, masks_g = stacks, masks
            agg = trimmed_mean_stacked_dev(stacks_g, masks_g, w_full > 0, trim)
        else:
            weights_full = w_full / torch.clamp_min(wsum, 1e-30)
            w_loc = (shard_row_slice(weights_full, w_local, mesh) if mesh is not None
                     else weights_full)
            agg = aggregate_by_worker_stacked_dev(stacks, w_loc, mesh)
    else:
        wsum = mult.sum()
        if mesh is not None:
            wsum = psum_fleet(wsum, mesh)
        if trim > 0.0:
            agg = robust_aggregate_stacked_dev(stacks, mult, masks, trim=trim, mesh=mesh)
        else:
            agg = aggregate_by_worker_stacked_dev(stacks, weights, mesh)
    new = {k: torch.where(wsum > 0, agg[k], global_p[k].float()) for k in stacks}
    return new, strikes2, quar2, quar_now
