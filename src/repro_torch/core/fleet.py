"""Fleet engine: how one round phase of local training is dispatched.

Port of ``repro/core/fleet.py``, selected by ``engine``:

* ``sequential`` — the reference engine: one ``train_plan`` call per worker,
  in worker order, on its physically small sub-model;
* ``bucketed``   — workers whose sub-models share a parameter-shape
  signature (and shard and plan shapes) train as one stack, one
  ``train_many`` call per bucket;
* ``masked``     — the resident engine below.

The first two take a list of ``FleetJob``s (``train_all``).  On the
masked engine ``train_all`` embeds each job's sub-model into the base
shape under its 0/1 coordinate masks and trains one stack per (shard, plan)
shape, then extracts each worker's reconfigured view.  ``run_simulation``
keeps the masked fleet resident instead: every worker stays at base shape;
its sub-model is a 0/1 coordinate mask, so the whole fleet trains as one
stack and a pruning event only rewrites mask rows.

* ``scatter_global``  — broadcast-back is a masked scatter ``P = g[None] * M``;
* ``scatter_global_rows`` — the async refetch: each committing row takes the
  global snapshot it fetched, ``P[w] = g_w * M[w]``;
* ``train_rounds``    — one trainer call over the whole stack, with per-step
  validity masks so ragged plans never change shapes;
* ``train_rows``      — participation-sized training: when only some slots
  have work (the phase-B pruners), their rows are gathered into a
  ``[B, ...]`` sub-stack, B padded to the next power of two, trained, and
  scattered back (``to_host``: the trained rows also come back in one host
  copy, the async schedulers' merge input);
* ``refresh_masks``   — rewrite the mask stack from the workers' global
  indices and re-mask the params (and the momentum carry);
* ``update_shard``    — a churned-in worker's fresh shard, written into its
  row of the resident data (on a mesh-sharded fleet, by the rank owning the
  slot, at its local row: ``global_to_shard_local``);
* ``init_momentum`` / ``zero_momentum_rows`` — the cross-round momentum
  carry (``SimConfig.resident_momentum``) and its reset on churn and crash
  recovery;
* aggregation consumes the stacks directly (``aggregation``).

The fused round engine (``core.fused``) keeps the same stacks but rebuilds
them on the device: ``masks_from_presence`` (the mask stacks from a ``[W,
U]`` flat presence matrix), ``gl_factors_from_counts`` (the group-lasso
factors from retained counts) and ``refetch_rows`` (the async refetch of the
flagged rows), all free of host synchronisation.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.optim.group_lasso import group_size_sqrt, group_size_sqrt_from_shapes

from .aggregation import (
    UnitMap,
    coordinate_mask,
    embed_params,
    extract_subparams,
    subparam_shapes,
)
from .masks import GlobalIndex, UnitFlat
from .worker import LocalTrainer, _sync, stack_batch_plans

__all__ = [
    "ENGINES",
    "FleetJob",
    "FleetEngine",
    "FleetState",
    "bucket_rows",
    "global_to_shard_local",
    "gather_stack_rows",
    "scatter_stack_rows",
    "masks_from_presence",
    "gl_factors_from_counts",
    "refetch_rows",
]

Tensors = Dict[str, torch.Tensor]

# "fused" shares the masked engine's resident stacks; its rounds run as
# chunks on the device (core.fused)
ENGINES = ("sequential", "bucketed", "masked", "fused")


def bucket_rows(n: int, cap: int, multiple: int = 1) -> int:
    """Sub-stack row bucket for ``n`` active rows: the smallest power of two
    >= n, capped at the fleet size.  ``multiple`` (the shard count of a
    mesh-sharded fleet) floors the bucket: a bucket below it rounds up to a
    multiple of it, so a gathered sub-stack divides over the fleet axis."""
    if n < 1:
        raise ValueError(f"bucket_rows needs n >= 1, got {n}")
    if multiple < 1:
        raise ValueError(f"bucket_rows needs multiple >= 1, got {multiple}")
    b = 1
    while b < n:
        b <<= 1
    b = min(b, cap)
    if b % multiple:
        b = min(-(-b // multiple) * multiple, cap)
        if b % multiple:
            raise ValueError(f"fleet size {cap} does not divide over {multiple} shards")
    return b


def global_to_shard_local(rows: Sequence[int], num_workers: int,
                          num_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """Global slot ids to ``(shard, local row)`` under the mesh-sharded
    fleet's contiguous layout: slot ``w`` lives on shard ``w // W_local`` at
    local row ``w % W_local``, ``W_local = W / num_shards``.  Out-of-range
    ids and fleets that do not divide raise instead of wrapping."""
    if num_shards < 1 or num_workers % num_shards:
        raise ValueError(f"fleet of {num_workers} does not divide over {num_shards} shards")
    rows = np.asarray(rows, np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= num_workers):
        raise ValueError(
            f"slot ids {rows[(rows < 0) | (rows >= num_workers)]} outside [0, {num_workers})"
        )
    w_local = num_workers // num_shards
    return rows // w_local, rows % w_local


def _row_index(rows: Sequence[int], num_rows: int, device) -> torch.Tensor:
    rows = np.asarray(rows, np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= num_rows):
        raise ValueError(
            f"row ids {rows[(rows < 0) | (rows >= num_rows)]} outside [0, {num_rows})"
        )
    return torch.as_tensor(rows, device=device)


def gather_stack_rows(stacks: Mapping[str, torch.Tensor], rows, num_rows: int) -> Tensors:
    """Gather rows of ``[W, ...]`` stacks into a ``[B, ...]`` sub-stack
    (``rows`` may repeat: bucket padding repeats the first row)."""
    out: Tensors = {}
    for k, v in stacks.items():
        out[k] = torch.index_select(v, 0, _row_index(rows, num_rows, v.device))
    return out


def scatter_stack_rows(
    stacks: Mapping[str, torch.Tensor], rows, sub: Mapping[str, torch.Tensor], num_rows: int
) -> Tensors:
    """Write the first ``len(rows)`` rows of a sub-stack back into the
    ``[W, ...]`` stacks (bucket-padding rows are discarded)."""
    n = len(rows)
    out: Tensors = {}
    for k, v in stacks.items():
        v = v.clone()
        v[_row_index(rows, num_rows, v.device)] = sub[k][:n]
        out[k] = v
    return out


def masks_from_presence(
    presence: torch.Tensor,                    # [W, U] flat 0/1
    flat: UnitFlat,
    unit_map: UnitMap,
    base_shapes: Mapping[str, tuple],
) -> Tensors:
    """The ``[W, ...]`` 0/1 mask stacks of a flat presence matrix, on its
    device: ``refresh_masks``'s product over governed axes."""
    W = presence.shape[0]
    rows = {
        name: presence[:, int(flat.offsets[l]) : int(flat.offsets[l] + flat.sizes[l])]
        for l, name in enumerate(flat.names)
    }
    masks: Tensors = {}
    for path, shape in base_shapes.items():
        m = torch.ones((W,) + tuple(shape), dtype=torch.float32, device=presence.device)
        for lname, axis in unit_map.get(path, ()):
            bshape = [W] + [1] * len(shape)
            bshape[1 + axis] = shape[axis]
            m = m * rows[lname].reshape(bshape)
        masks[path] = m
    return masks


def gl_factors_from_counts(
    counts: Mapping[str, torch.Tensor],        # {lname: [W] retained counts, float32}
    unit_map: UnitMap,
    base_shapes: Mapping[str, tuple],
) -> Tensors:
    """Per-worker sqrt-group-size factors from retained counts alone, in
    float32 (``group_size_sqrt_from_shapes`` of the reconfigured shapes): a
    path's reconfigured numel is its base numel with each governed axis
    rescaled by ``count / base``, and a layer's group size sums ``numel /
    count`` over the paths it governs."""
    numel: Tensors = {}
    for path, shape in base_shapes.items():
        val = None
        for lname, axis in unit_map.get(path, ()):
            c = counts[lname]
            if val is None:
                val = torch.full_like(c, float(np.prod(shape)))
            val = val / float(shape[axis]) * c
        if val is not None:
            numel[path] = val
    sizes: Tensors = {}
    for path, entries in unit_map.items():
        if path not in base_shapes:
            continue
        for lname, axis in entries:
            contrib = numel[path] / torch.clamp_min(counts[lname], 1.0)
            sizes[lname] = contrib if lname not in sizes else sizes[lname] + contrib
    # the root in float64, rounded to float32 once: correctly rounded, as
    # XLA's and numpy's float32 sqrt are and torch's CPU one is not on every
    # CPU (sqrt(42) one ulp high)
    return {lname: torch.sqrt(v.double()).to(v.dtype) for lname, v in sizes.items()}


def refetch_rows(
    fetched: Mapping[str, torch.Tensor],       # {path: [W, ...]} fetched snapshots
    refetch_mask: torch.Tensor,                # [W] 0/1: rows taking the global
    global_p: Mapping[str, torch.Tensor],      # {path: [...]} current global
) -> Tensors:
    """Masked refetch: flagged rows take the current global, the others keep
    their snapshot (the fused async engine's ``fetched[w] = global``; the
    mask is a device tensor, so SSP's releases stay on the device)."""
    out: Tensors = {}
    for k, v in fetched.items():
        sel = refetch_mask.reshape((-1,) + (1,) * (v.dim() - 1)) > 0
        out[k] = torch.where(sel, global_p[k].unsqueeze(0), v)
    return out


@dataclasses.dataclass
class FleetState:
    """Resident multi-worker state: every tensor is a ``[W, ...]`` stack on
    the device.  ``params`` rows are always masked (pruned coordinates
    exactly 0); ``gl_sizes`` holds each worker's sqrt-group-size factors of
    its reconfigured shapes, so the group-lasso penalty equals the
    physically small twin's.  ``momentum`` is the cross-round optimizer
    carry (``init_momentum``), ``None`` when momentum restarts per phase.

    On a mesh-sharded fleet the stacks hold only this rank's ``W_local =
    num_workers / num_shards`` rows, global slots ``[row_offset, row_offset
    + W_local)``; ``num_workers`` stays the fleet's W."""

    params: Tensors
    masks: Tensors
    xs: torch.Tensor                 # [W_local, n_max, H, W, 3] padded shards
    ys: torch.Tensor                 # [W_local, n_max]
    num_workers: int
    gl_sizes: Dict[str, np.ndarray]
    momentum: Optional[Tensors] = None
    num_shards: int = 1
    row_offset: int = 0

    @property
    def w_local(self) -> int:
        return self.num_workers // self.num_shards

    def local_rows(self, rows: Sequence[int]) -> List[int]:
        """The local rows of the global slots ``rows`` this rank holds."""
        shard, local = global_to_shard_local(rows, self.num_workers, self.num_shards)
        mine = self.row_offset // self.w_local
        return [int(r) for s, r in zip(shard, local) if s == mine]


@dataclasses.dataclass
class FleetJob:
    """One worker's local-training work item for a round phase."""

    worker: int
    params: Tensors           # reconfigured (physically small) sub-model
    index: GlobalIndex        # its global index I_w (base coordinates)
    x: np.ndarray             # this worker's data shard
    y: np.ndarray
    plan: np.ndarray          # [steps, batch] make_batch_plan output


class FleetEngine:
    """Trains the fleet through a ``LocalTrainer``: a list of jobs on the
    reconfiguring engines, the resident stacks on the masked one."""

    def __init__(self, trainer: LocalTrainer, unit_map: UnitMap,
                 base_shapes: Mapping[str, tuple], device="cpu", engine: str = "masked"):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
        self.trainer = trainer
        self.unit_map = unit_map
        self.base_shapes = base_shapes
        self.device = torch.device(device)
        self.engine = engine
        self.batched_calls = 0           # stacked training calls launched
        self.buckets_used: set = set()   # resident sub-stack row counts launched
        self.pull_walltime_s = 0.0       # train_rows(to_host=True) copies, after a sync
        self._mask_cache: Dict[tuple, Tensors] = {}   # train_all's masks, by global index

    # ------------------------------------------------------------------
    # reconfiguring engines: physically small sub-models
    # ------------------------------------------------------------------

    def train_all(self, jobs: Sequence[FleetJob], lam: float = 0.0) -> List[Tensors]:
        """Train every job; returns the trained sub-model params aligned
        with ``jobs`` (a job with an empty plan comes back untouched)."""
        results: List[Tensors] = [dict(j.params) for j in jobs]
        live = [i for i, j in enumerate(jobs) if j.plan.shape[0] > 0]
        if self.engine == "sequential":
            for i in live:
                j = jobs[i]
                results[i], _ = self.trainer.train_plan(
                    j.params, self.unit_map, j.x, j.y, j.plan, lam
                )
        elif self.engine == "bucketed":
            buckets: Dict[tuple, List[int]] = {}
            for i in live:
                j = jobs[i]
                shapes = tuple(sorted((k, tuple(v.shape)) for k, v in j.params.items()))
                buckets.setdefault((shapes, j.x.shape, j.plan.shape), []).append(i)
            for members in buckets.values():
                js = [jobs[i] for i in members]
                trained, _ = self.trainer.train_many(
                    [j.params for j in js], self.unit_map,
                    np.stack([j.x for j in js]), np.stack([j.y for j in js]),
                    np.stack([j.plan for j in js]), lam,
                )
                self.batched_calls += 1
                for i, p in zip(members, trained):
                    results[i] = p
        else:
            self._run_masked(jobs, live, results, lam)
        return results

    def _mask_for(self, index: GlobalIndex) -> Tensors:
        """A worker's 0/1 coordinate masks at base shape, on the device,
        cached by its global index."""
        key = tuple(sorted((k, tuple(map(int, v))) for k, v in index.items()))
        m = self._mask_cache.get(key)
        if m is None:
            m = {path: torch.as_tensor(
                     coordinate_mask(path, index, self.unit_map, self.base_shapes),
                     dtype=torch.float32, device=self.device)
                 for path in self.base_shapes}
            self._mask_cache[key] = m
        return m

    def _run_masked(self, jobs, live, results, lam):
        """Every sub-model embedded into the base shape under its masks:
        one stacked call per (shard, plan) shape, each worker's
        reconfigured view extracted back out."""
        buckets: Dict[tuple, List[int]] = {}
        for i in live:
            j = jobs[i]
            buckets.setdefault((j.x.shape, j.plan.shape), []).append(i)
        for members in buckets.values():
            js = [jobs[i] for i in members]
            embedded = [embed_params(j.params, j.index, self.unit_map, self.base_shapes)
                        for j in js]
            trained, _ = self.trainer.train_many(
                embedded, self.unit_map,
                np.stack([j.x for j in js]), np.stack([j.y for j in js]),
                np.stack([j.plan for j in js]), lam,
                masks=[self._mask_for(j.index) for j in js],
                # group-lasso factors from the RECONFIGURED shapes: the
                # penalty of the physically small model, not the base one
                gl_sizes=[group_size_sqrt(j.params, self.unit_map) for j in js],
            )
            self.batched_calls += 1
            for i, base_p in zip(members, trained):
                results[i] = extract_subparams(base_p, jobs[i].index, self.unit_map)

    # ------------------------------------------------------------------
    # resident masked engine: [W, ...] stacks on the device
    # ------------------------------------------------------------------

    def init_state(self, base_params: Tensors, shards_x: Sequence[np.ndarray],
                   shards_y: Sequence[np.ndarray], sharding=None) -> FleetState:
        """Stack W full-model replicas + their data shards on the device.
        Shards are padded to the longest; plans never index the padding.
        ``sharding`` (``sharding.specs.FleetSharding``, or None) keeps only
        this rank's rows of every stack, padded to the whole fleet's longest
        shard."""
        W = len(shards_x)
        sizes = np.array([len(x) for x in shards_x], dtype=np.int64)
        n_max = int(sizes.max())
        n_shards = 1 if sharding is None else sharding.num_shards
        lo = 0 if sharding is None else sharding.row_offset(W)
        rows = range(lo, lo + W // n_shards)
        xs = np.zeros((len(rows), n_max) + shards_x[0].shape[1:], np.float32)
        ys = np.zeros((len(rows), n_max), np.int64)
        for i, w in enumerate(rows):
            xs[i, : sizes[w]] = shards_x[w]
            ys[i, : sizes[w]] = shards_y[w]
        dev = self.device
        params = {
            k: v.to(dev).unsqueeze(0).expand((len(rows),) + tuple(v.shape)).contiguous()
            for k, v in base_params.items()
        }
        masks = {k: torch.ones_like(v) for k, v in params.items()}
        return FleetState(
            params=params, masks=masks,
            xs=torch.as_tensor(xs, device=dev), ys=torch.as_tensor(ys, device=dev),
            num_workers=W,
            gl_sizes={
                lname: np.full((W,), s, np.float32)
                for lname, s in group_size_sqrt_from_shapes(
                    self.base_shapes, self.unit_map
                ).items()
            },
            num_shards=n_shards, row_offset=lo,
        )

    def update_shard(self, state: FleetState, w: int, x: np.ndarray, y: np.ndarray):
        """Swap worker ``w``'s data shard in place (a churn join); the shard
        is padded to the resident length, which it must not exceed.  Only
        the rank holding slot ``w`` writes, at its local row."""
        n_max = state.xs.shape[1]
        if len(x) > n_max:
            raise ValueError(f"churn shard ({len(x)}) exceeds resident pad ({n_max})")
        for r in state.local_rows([w]):
            xr = np.zeros((n_max,) + x.shape[1:], np.float32)
            yr = np.zeros((n_max,), np.int64)
            xr[: len(x)], yr[: len(y)] = x, y
            state.xs[r] = torch.as_tensor(xr, device=state.xs.device)
            state.ys[r] = torch.as_tensor(yr, device=state.ys.device)

    def init_momentum(self, state: FleetState):
        """Zero momentum stack: the cross-round carry of
        ``SimConfig.resident_momentum``."""
        state.momentum = {k: torch.zeros_like(v) for k, v in state.params.items()}

    def zero_momentum_rows(self, state: FleetState, rows: Sequence[int]):
        """Restart the momentum of these worker rows (churn joins and crash
        recoveries: velocity accumulated against other parameters)."""
        if state.momentum is None or not len(rows):
            return
        local = state.local_rows(rows)
        for v in state.momentum.values():
            v[_row_index(local, state.w_local, v.device)] = 0.0

    def params_host(self, state: FleetState) -> Dict[str, np.ndarray]:
        """Host copy of the param stack (the DGC submission boundary)."""
        return {k: v.cpu().numpy() for k, v in state.params.items()}

    def masks_host(self, state: FleetState) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in state.masks.items()}

    def _unit_dims(self) -> Dict[str, int]:
        dims: Dict[str, int] = {}
        for path, entries in self.unit_map.items():
            for lname, axis in entries:
                dims[lname] = self.base_shapes[path][axis]
        return dims

    def refresh_masks(self, state: FleetState, indices: Sequence[GlobalIndex]):
        """Rewrite the mask stack from the global indices and re-mask the
        params: the only thing a pruning event does to the resident state."""
        W = state.num_workers
        presence: Dict[str, np.ndarray] = {}
        for lname, dim in self._unit_dims().items():
            p = np.zeros((W, dim), np.float32)
            for w in range(W):
                p[w, np.asarray(indices[w][lname], np.int64)] = 1.0
            presence[lname] = p
        for path, shape in self.base_shapes.items():
            m = torch.ones((W,) + tuple(shape), device=self.device)
            for lname, axis in self.unit_map.get(path, ()):
                bshape = [W] + [1] * len(shape)
                bshape[1 + axis] = shape[axis]
                m = m * torch.as_tensor(presence[lname], device=self.device).reshape(bshape)
            state.masks[path] = m
            state.params[path] = state.params[path] * m
            if state.momentum is not None:
                # a pruned unit's velocity dies with it
                state.momentum[path] = state.momentum[path] * m
        for w in range(W):
            shapes = subparam_shapes(indices[w], self.unit_map, self.base_shapes)
            for lname, s in group_size_sqrt_from_shapes(shapes, self.unit_map).items():
                state.gl_sizes[lname][w] = s

    def scatter_global(self, state: FleetState, global_params: Tensors):
        """Broadcast-back as a masked scatter: ``P = g[None] * M``."""
        for path, g in global_params.items():
            state.params[path] = g.unsqueeze(0) * state.masks[path]

    def scatter_global_rows(self, state: FleetState, rows: Sequence[int],
                            globals_list: Sequence[Mapping[str, np.ndarray]]):
        """Masked scatter of per-row global snapshots (host arrays): row
        ``rows[i]`` becomes ``globals_list[i] * M[rows[i]]``.  Each async
        committer refetched its own global version, so the snapshots are
        stacked on the host and written with one device op per tensor (in
        float32: a clipped commit leaves the server's params in float64)."""
        idx = _row_index(rows, state.num_workers, self.device)
        for path in state.params:
            g = torch.as_tensor(np.stack([np.asarray(gl[path], np.float32)
                                          for gl in globals_list]), device=self.device)
            v = state.params[path].clone()
            v[idx] = g * torch.index_select(state.masks[path], 0, idx)
            state.params[path] = v

    def stack_plans(self, plans, pad_rows: Optional[int] = None,
                    pad_steps: Optional[int] = None):
        """Per-row plans -> device ``[R, S, batch]`` plan stack + ``[R, S]``
        validity mask, or ``None`` when no row has a step."""
        stacked = stack_batch_plans(plans, num_rows=pad_rows, num_steps=pad_steps)
        if stacked is None:
            return None
        stack, valid = stacked
        return (torch.as_tensor(stack, device=self.device),
                torch.as_tensor(valid, device=self.device))

    def _gl(self, state: FleetState, rows) -> Tensors:
        return {
            k: torch.as_tensor(np.asarray(v)[list(rows)], device=self.device)
            for k, v in state.gl_sizes.items()
        }

    def train_rounds(self, state: FleetState, plans: Sequence[Optional[np.ndarray]],
                     lam: float = 0.0, pad_steps: Optional[int] = None,
                     carry_momentum: bool = False) -> Optional[np.ndarray]:
        """One trainer call for a whole round phase.  Rows without a plan
        are neither trained nor computed: fewer than W active rows go
        through ``train_rows``.  ``carry_momentum`` starts the optimizer
        from ``state.momentum`` and keeps the trained rows' momentum as the
        next carry.  Returns per-worker mean losses (idle rows 0), or
        ``None`` if nobody had work."""
        W = state.num_workers
        rows = [w for w, p in enumerate(plans) if p is not None and p.shape[0] > 0]
        if not rows:
            return None
        if len(rows) == W:
            plan_stack, valid = self.stack_plans(plans, pad_steps=pad_steps)
            state.params, mom, losses = self.trainer.train_resident(
                state.params, state.masks, self.unit_map, state.xs, state.ys,
                plan_stack, valid, lam, self._gl(state, range(W)),
                momentum_in=state.momentum if carry_momentum else None,
            )
            if carry_momentum:
                state.momentum = mom
            self.batched_calls += 1
            self.buckets_used.add(W)
            return losses.cpu().numpy()
        losses, _ = self.train_rows(state, rows, [plans[w] for w in rows], lam, pad_steps,
                                    carry_momentum=carry_momentum)
        full = np.zeros(W, np.float32)
        full[rows] = losses
        return full

    def train_rows(self, state: FleetState, rows: Sequence[int],
                   plans: Sequence[Optional[np.ndarray]], lam: float = 0.0,
                   pad_steps: Optional[int] = None, carry_momentum: bool = False,
                   to_host: bool = False) -> Tuple[np.ndarray, Optional[Dict[str, np.ndarray]]]:
        """Gather ``rows`` into a bucket-sized sub-stack, train it in one
        call, scatter the trained rows back.  ``plans`` aligns with ``rows``.
        Bucket padding repeats ``rows[0]`` with an all-invalid plan: it is
        computed and discarded.  Returns ``(losses[len(rows)], trained)``:
        with ``to_host`` the trained ``{path: [len(rows), ...]}`` rows in
        one host copy, else ``None`` (also when no row has a step)."""
        W = state.num_workers
        B = len(rows)
        bucket = bucket_rows(B, W)
        rows = [int(w) for w in rows]
        rows_pad = rows + [rows[0]] * (bucket - B)
        stacked = self.stack_plans(list(plans) + [None] * (bucket - B),
                                   pad_rows=bucket, pad_steps=pad_steps)
        if stacked is None:
            return np.zeros(B, np.float32), None
        plan_stack, valid = stacked
        sub_params = gather_stack_rows(state.params, rows_pad, W)
        sub_masks = gather_stack_rows(state.masks, rows_pad, W)
        idx = _row_index(rows_pad, W, self.device)
        mom_in = gather_stack_rows(state.momentum, rows_pad, W) if carry_momentum else None
        out, mom, losses = self.trainer.train_resident(
            sub_params, sub_masks, self.unit_map,
            torch.index_select(state.xs, 0, idx), torch.index_select(state.ys, 0, idx),
            plan_stack, valid, lam, self._gl(state, rows_pad), momentum_in=mom_in,
        )
        self.batched_calls += 1
        self.buckets_used.add(bucket)
        state.params = scatter_stack_rows(state.params, rows, out, W)
        if carry_momentum:
            state.momentum = scatter_stack_rows(state.momentum, rows, mom, W)
        trained = None
        if to_host:
            _sync(self.device)
            t0 = _time.perf_counter()
            trained = {k: v[:B].cpu().numpy() for k, v in out.items()}
            self.pull_walltime_s += _time.perf_counter() - t0
        return losses.cpu().numpy()[:B], trained
