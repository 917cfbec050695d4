"""Fused round engine: chunks of whole rounds on the device, between host
boundaries.

Port of ``repro/core/fused.py`` (``SimConfig.engine = "fused"``).  The
resident masked engine keeps the fleet's ``[W, ...]`` stacks on the device
but crosses to the host every round: a host DGC compressor, float64 host
aggregation, host importance scoring and ``prune_to_budget``, a host mask
rewrite.  Here the whole synchronous round runs on the device: masked
broadcast-back (``g[None] * M``), training of all W rows with per-step
validity masks, the prune greedy (``masks.prune_presence_rows``) and
phase B, DGC (``aggregation.dgc_compress_dev``) and float32 aggregation,
or under the byzantine and channel families and ``SimConfig.robust`` the
robust server round (``aggregation.robust_submission_step_dev``, the
function the masked loop calls) with the quarantine's health carry.
The reference expresses a chunk of rounds as one ``lax.scan`` program; here
a chunk is a Python loop over its rounds in which every tensor stays on the
device and nothing synchronises the host (no ``.item()``, ``.cpu()``,
``nonzero`` or boolean-mask indexing).  Every per-round control value the
scan takes as a traced input is known on the host before the chunk starts
(which rounds prune, which are real, the budgets, the static-criterion
orders, crash recoveries, submitters, weights, batch plans, the commit
multiplicities, the attacked and corrupted rows and the rounds the noise
keys fold in), so the scan's ``lax.cond`` on ``prune_any`` is a host ``if``
here.  After a chunk the host reads back, once: the ``[n, W, U]`` presence
trail, the globals of its eval rounds, the DGC kept/total counts and the
``[n, W]`` quarantine trail, and does the accounting of the reference
(ledger, payloads, the channel-model clock with its retries, evaluation).

**Chunk boundaries** are the reference's: Newton pruned-rate learning
(every ``prune_interval`` rounds for adaptcl, and at drift events) stays on
the host, so chunks span the rounds between learning events, capped at
``SimConfig.round_fusion``; churn, drift-change and FedDST regrow rounds cut
them too (the host ``_regrow_step`` runs at the boundary).  Sampling,
dropout, crash recovery, outage and skipped rounds ride inside a chunk.

**Decisions are host-exact.**  Scenario events are pre-drawn
(``ScenarioEngine.draw_all``), batch plans and jitter per round in the lazy
loop's ``env.rng`` order.  The static criteria's removal orders are
``masks.prune_order`` permutations, the budgets exact integers
(``prune_budget_units``), so their prune events are bit-identical to the
host path.  The data-dependent criteria l1 and taylor
(``importance.DEVICE_METHODS``) are scored on the device in float32 and
ordered by a two-key stable sort (score, then the ``(layer, unit)`` rank),
as ``jnp.lexsort`` orders them.  The reference's fused engine aggregates in
float32 on the device, the host engines in float64; the port's fused engine
is held to the reference's fused engine.

**Dead rounds.**  The reference pads every chunk to ``K_pad`` rounds so one
compiled program serves them all; a padding round changes no carried tensor
(the broadcast-back it does is overwritten by the next round's).  Nothing is
compiled here, so padding rounds are not run, and a skipped round (too few
fault survivors) runs only its crash-recovery resets and the broadcast-back.
``RUN_DEAD_ROUNDS`` runs them in full, as the scan does (a test holds both
ways to the same carried state).

**Async.**  ``run_async_fused`` replays the ``AsyncEventPlan`` of
``simulation._plan_async_events`` in chunks of ``round_fusion`` window
batches.  Each batch's events arrive in heap push order with split float64
finish keys; ``async_pop_perm`` re-derives the commit order on the device
(three stable sorts, the host heap's ``(time, worker)`` order), the batch
trains as one stack from the gathered snapshots, and each commit merges
through ``aggregation.async_commit_dev`` with integer staleness counters,
dropout gating, the robust layer's clip and per-commit quarantine
(``aggregation.async_health_step_dev``) and masked refetch
(``fleet.refetch_rows``).  After a chunk the host compares the device pop
order and staleness with the plan and raises on any difference.

**The mesh-sharded fleet** (``SimConfig.mesh``, a ``launch.mesh.FleetMesh``
over ``torch.distributed``) runs the sync chunk on each rank's ``W_local =
W / n`` rows, as the reference's ``shard_map`` over the ``fleet`` axis
does.  Every rank replays the same host streams and keeps only its rows of
the state (params, masks, momentum, DGC residual, data) and of the
per-round inputs (the reference's ``per_round_specs``: plans, budgets,
weights, submitters, recoveries, multiplicities, attacked and corrupted
rows; ``prune_any``, ``real`` and the noise rounds are the fleet's).  The
ranks meet only in ``sharding.collectives``: the aggregation's
``psum_fleet`` and the robust layer's all-gathers inside a chunk, then one
all-gather of the presence and DGC trails after it, so every rank does the
reference's accounting on the whole fleet and returns the same result.
The quarantine's health rows are the whole fleet's on every rank.

Refused, as in the reference: ``compute="block_skip"``, and the mesh off
this engine or with an async method (``simulation.validate_config``).
"""
from __future__ import annotations

import time as _time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.cnn import cnn_flops_from_shapes, extract_bn_scales
from repro_torch.optim.group_lasso import group_size_sqrt_from_shapes, unit_group_norms
from repro_torch.sharding.collectives import all_gather_fleet
from repro_torch.sharding.specs import fleet_sharding

from .aggregation import (
    aggregate_by_unit_stacked_dev,
    aggregate_by_worker_stacked_dev,
    async_commit_dev,
    async_health_step_dev,
    delta_norms_dev,
    dgc_compress_dev,
    extract_subparams,
    noise_key,
    robust_submission_step_dev,
    roundtrip_total,
    subparam_shapes,
)
from .faults import fault_ledger
from .fleet import gl_factors_from_counts, masks_from_presence, refetch_rows
from .importance import (
    DEVICE_METHODS,
    METHODS,
    STATIC_METHODS,
    ImportanceContext,
    l1_scores,
    taylor_scores,
)
from .masks import (
    UnitFlat,
    _walk_tensors,
    flatten_unit_space,
    full_index,
    index_from_presence,
    presence_from_index,
    prune_budget_units,
    prune_order,
    prune_presence_rows,
    retention,
    similarity,
)
from .pruned_rate import WorkerHistory, learn_pruned_rates
from .scenario import ScenarioEngine, ScenarioPlan
from .timing import heterogeneity_from_times
from .worker import make_batch_plan, plan_steps, stack_batch_plans

__all__ = [
    "run_sync_fused",
    "run_async_fused",
    "async_pop_perm",
    "split_time_keys",
    "validate_fused_config",
    "device_order",
]

Tensors = Dict[str, torch.Tensor]

# run padding and skipped rounds in full, as the reference's scan does
RUN_DEAD_ROUNDS = False


def validate_fused_config(sim) -> None:
    """The reference's refusals for the fused engine, with its reasons, and
    its checks of a mesh: the fleet axis is there and W divides over it."""
    if sim.compute != "dense":
        raise ValueError(
            "SimConfig.compute: engine='fused' supports compute='dense' only "
            "— the block_skip interpret-mode kernel inside lax.scan is out of "
            "scope off-TPU (the reference's rule)"
        )
    supported = STATIC_METHODS | DEVICE_METHODS
    if sim.importance not in supported:
        raise ValueError(
            f"SimConfig.importance: engine='fused' supports importance criteria "
            f"{sorted(supported)}; {sim.importance!r} needs host-side statistics "
            "(use engine='masked')"
        )
    mesh = sim.mesh
    if mesh is not None:
        axis = sim.fleet_axis
        if axis not in mesh.shape:
            raise ValueError(
                f"SimConfig.mesh axes {tuple(mesh.shape)} have no fleet axis {axis!r} "
                "(SimConfig.fleet_axis)"
            )
        n_dev = mesh.shape[axis]
        if sim.num_workers % n_dev:
            raise ValueError(
                f"num_workers={sim.num_workers} does not divide over the {n_dev}-way "
                f"{axis!r} mesh axis (W = n_dev x W_local)"
            )


def device_order(scores: torch.Tensor, tiebreak_perm: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((tiebreak, scores))`` per row of ``[W, U]`` scores:
    ascending score, ties by ascending ``UnitFlat.tiebreak`` rank.
    ``tiebreak_perm`` is ``argsort(tiebreak)``: the rows are first laid out
    in tie-break order, then stably sorted by score."""
    s = scores[:, tiebreak_perm]
    idx = torch.sort(s, dim=1, stable=True).indices
    return tiebreak_perm[idx]


def _static_orders(sim, env, flat: UnitFlat, cig_scores, prune_round_count):
    """Host-exact ``[W, U]`` removal orders of the data-independent criteria
    (``None`` while the CIG scores are not frozen: no prune fires before the
    first learning event)."""
    W = sim.num_workers
    name = sim.importance
    if name == "cig_bnscalor":
        if cig_scores is None:
            return None
        return np.tile(prune_order(cig_scores, flat), (W, 1))
    ctx = dict(unit_counts=env.space.unit_counts, round=prune_round_count, seed=sim.seed)
    if name != "no_identical":    # one order shared by every worker
        scores = METHODS[name](ImportanceContext(**ctx))
        return np.tile(prune_order(scores, flat), (W, 1))
    return np.stack([
        prune_order(METHODS[name](ImportanceContext(worker=w, **ctx)), flat) for w in range(W)
    ])


class _SyncChunk:
    """The round body of the sync chunk, applied to the rounds of one chunk.

    Carry: param, mask, presence, global, momentum, DGC-residual stacks and
    the quarantine's health rows.  Per-round device inputs arrive as
    ``[K, ...]`` tensors, the host flags as numpy arrays.  Returns the carry
    and the per-round outputs the host reads back: ``[n, W, U]`` presence,
    the globals of the eval rounds, the ``[n, W]`` DGC kept/total counts and
    the ``[n, W]`` quarantine trail.

    ``robust`` holds the robust statics, ``(attack on, corruption on,
    noise seed, robust_submission_step_dev's keyword arguments)``, or is
    None: a channel with ``corrupt=0`` still takes the robust round, since
    its multiplicities reshape the weights and an all-lost round must keep
    the global by the same code as the masked loop."""

    def __init__(self, trainer, unit_map, base_shapes, flat: UnitFlat, lam: float, *,
                 by_unit: bool, importance: str, resident_momentum: bool, has_phase_b: bool,
                 dgc_sparsity: float, device, robust=None, mesh=None, full_rows=None):
        self.trainer = trainer
        self.unit_map = unit_map
        self.base_shapes = base_shapes
        self.flat = flat
        self.lam = lam
        self.by_unit = by_unit
        self.importance = importance
        self.resident_momentum = resident_momentum
        self.has_phase_b = has_phase_b
        self.dgc_sparsity = dgc_sparsity
        self.robust = robust
        self.mesh = mesh
        self.full_rows = full_rows
        self.walk = _walk_tensors(flat, device)
        self.tiebreak_perm = torch.as_tensor(
            np.argsort(flat.tiebreak, kind="stable").astype(np.int64), device=device)
        self.slices = [(name, int(flat.offsets[l]), int(flat.sizes[l]))
                       for l, name in enumerate(flat.names)]

    def gl_of(self, presence: torch.Tensor) -> Tensors:
        counts = {name: presence[:, off : off + sz].sum(dim=1) for name, off, sz in self.slices}
        return gl_factors_from_counts(counts, self.unit_map, self.base_shapes)

    def train(self, params, masks, presence, xs, ys, plans, valid, momentum):
        return self.trainer._train_stack(
            params, masks, self.unit_map, xs, ys, plans, valid, self.lam,
            self.gl_of(presence), momentum,
        )

    def device_scores(self, params, masks, presence, xs, ys, sizes) -> torch.Tensor:
        """l1: per-unit group norms of the masked stacks; taylor: |sum g.w|
        per unit, g the gradient of each row's masked cross-entropy on its
        first <= 64 shard images.  Rows share no parameter, so one backward
        of the summed row losses gives every row's own gradient."""
        if self.importance == "l1":
            with torch.no_grad():
                norms, _ = unit_group_norms(params, self.unit_map, batch_dims=1)
            return l1_scores(norms, self.flat.names, presence)
        nb = min(64, xs.shape[1])
        xb, yb = xs[:, :nb], ys[:, :nb]
        wv = (torch.arange(nb, device=xs.device).unsqueeze(0)
              < torch.clamp_max(sizes, nb).unsqueeze(1)).float()
        with torch.enable_grad():
            q = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            qm = {k: q[k] * masks[k] for k in q}
            logp = F.log_softmax(self.trainer.masked_logits(qm, masks, xb), dim=-1)
            pick = logp.gather(-1, yb.unsqueeze(-1)).squeeze(-1)
            loss = -(pick * wv).sum(dim=1) / torch.clamp_min(wv.sum(dim=1), 1.0)
            keys = list(q)
            grads = dict(zip(keys, torch.autograd.grad(loss.sum(), [q[k] for k in keys])))
        gw: Tensors = {}
        with torch.no_grad():
            for path, entries in self.unit_map.items():
                if path not in grads:
                    continue
                g, w_ = grads[path], params[path]
                for lname, axis in entries:
                    red = tuple(i for i in range(g.dim()) if i not in (0, 1 + axis))
                    prod = g * w_
                    if red:   # torch's sum over dim=() would reduce everything
                        prod = prod.sum(dim=red)
                    term = prod.abs()
                    gw[lname] = term if lname not in gw else gw[lname] + term
        return taylor_scores(gw, self.flat.names, presence)

    def robust_round(self, agg_in, masks, global_p, health, per_round, flags, j):
        """The robust server round j: ``robust_submission_step_dev`` with the
        noise keys of the round (seed + 51721 attack, seed + 51722
        corruption) and the health carry, gated by the round being real."""
        byz_on, corrupt_on, seed, kw = self.robust
        rnd = int(flags["rnd"][j])
        g_new, st2, qu2, quar_row = robust_submission_step_dev(
            agg_in, masks, global_p, per_round["mult"][j], per_round["weights"][j],
            flags["byz"][j] if byz_on else None, flags["corrupt"][j] if corrupt_on else None,
            noise_key(seed + 51721, rnd) if byz_on else None,
            noise_key(seed + 51722, rnd) if corrupt_on else None,
            health.get("strikes"), health.get("quar"), gate=bool(flags["real"][j]),
            full_rows=self.full_rows, mesh=self.mesh, **kw,
        )
        if kw["quarantine"] is not None:
            health = {"strikes": st2, "quar": qu2}
        return g_new, health, quar_row

    def __call__(self, params, momentum, presence, global_p, dgc_res, health, xs, ys, sizes,
                 per_round, flags, orders, n_rounds, eval_rounds, run_dead=False):
        masks = masks_from_presence(presence, self.flat, self.unit_map, self.base_shapes)
        use_dgc = self.dgc_sparsity > 0.0
        rm = self.resident_momentum
        pres_seq: List[torch.Tensor] = []
        kept_seq: List[torch.Tensor] = []
        total_seq: List[torch.Tensor] = []
        quar_seq: List[torch.Tensor] = []
        evals: Dict[int, Tensors] = {}
        W = presence.shape[0]
        zeros_w = torch.zeros(W, dtype=torch.int32, device=presence.device)
        # the quarantine trail is the whole fleet's on every rank
        no_quar = torch.zeros(self.full_rows or W, dtype=torch.bool, device=presence.device)
        n_run = len(flags["real"]) if run_dead else n_rounds

        def record(j, kept_w, total_w, quar_row=None):
            if j < n_rounds:     # padding rounds report nothing
                pres_seq.append(presence)
                kept_seq.append(kept_w)
                total_seq.append(total_w)
                quar_seq.append(no_quar if quar_row is None else quar_row)
                if j in eval_rounds:
                    evals[j] = global_p

        for j in range(n_run):
            # crash recovery at the round start: returning rows keep their
            # mask, but their velocity and DGC residual restart (x * 1.0 is
            # exact, so rows without a recovery need no multiply)
            if (rm or use_dgc) and (run_dead or flags["recov_any"][j]):
                keep = 1.0 - per_round["recov"][j]
                if rm:
                    momentum = {k: v * keep.reshape((-1,) + (1,) * (v.dim() - 1))
                                for k, v in momentum.items()}
                if use_dgc:
                    dgc_res = {k: v * keep.reshape((-1,) + (1,) * (v.dim() - 1))
                               for k, v in dgc_res.items()}
            params = {k: global_p[k].unsqueeze(0) * masks[k] for k in params}
            if not (flags["real"][j] or run_dead):
                # a skipped round: nothing trains, prunes or aggregates
                record(j, zeros_w, zeros_w)
                continue
            params, m_out, _ = self.train(params, masks, presence, xs, ys,
                                          per_round["plan_a"][j], per_round["valid_a"][j],
                                          momentum if rm else None)
            if rm:
                momentum = m_out
            if flags["prune_any"][j]:
                if self.importance in STATIC_METHODS:
                    ow = orders
                else:
                    ow = device_order(
                        self.device_scores(params, masks, presence, xs, ys, sizes),
                        self.tiebreak_perm)
                presence = prune_presence_rows(presence, ow, per_round["budgets"][j],
                                               self.flat, self.walk)
                masks = masks_from_presence(presence, self.flat, self.unit_map, self.base_shapes)
                params = {k: v * masks[k] for k, v in params.items()}
                if rm:
                    momentum = {k: v * masks[k] for k, v in momentum.items()}
                if self.has_phase_b:
                    params, m_b, _ = self.train(params, masks, presence, xs, ys,
                                                per_round["plan_b"][j], per_round["valid_b"][j],
                                                momentum if rm else None)
                    if rm:
                        momentum = m_b
            submitters = per_round["submitters"][j]
            if use_dgc:
                deltas = {k: params[k] - global_p[k].unsqueeze(0) * masks[k] for k in params}
                committed, dgc_res, kept_w, total_w = dgc_compress_dev(
                    deltas, dgc_res, self.dgc_sparsity, masks, submitters)
                agg_in = {k: global_p[k].unsqueeze(0) * masks[k] + committed[k] for k in params}
            else:
                agg_in = params
                kept_w = total_w = zeros_w
            quar_row = None
            if self.by_unit:
                g_new = aggregate_by_unit_stacked_dev(agg_in, masks, submitters, self.mesh)
            elif self.robust is not None:
                g_new, health, quar_row = self.robust_round(agg_in, masks, global_p, health,
                                                            per_round, flags, j)
            else:
                g_new = aggregate_by_worker_stacked_dev(agg_in, per_round["weights"][j], self.mesh)
            if flags["real"][j]:
                global_p = {k: v.float() for k, v in g_new.items()}
            record(j, kept_w, total_w, quar_row)
        return (params, momentum, presence, global_p, dgc_res, health,
                torch.stack(pres_seq), evals, torch.stack(kept_seq), torch.stack(total_seq),
                torch.stack(quar_seq))


def run_sync_fused(sim, env):
    """Synchronous simulation on the fused round engine (see the module
    doc): ``simulation._run_sync`` decision for decision, with the rounds
    of each chunk on the device and the accounting on the host after it."""
    from .simulation import (   # deferred: simulation routes here
        _commit_multiplicity,
        _env_accuracy,
        _finalize,
        _regrow_round,
        _regrow_step,
        _robust_statics,
        _robust_step_kwargs,
        _skip_round_time,
    )

    W = sim.num_workers
    dev = env.device
    use_dgc = sim.dgc_sparsity > 0.0
    adapt = sim.method == "adaptcl"
    sparse = sim.method in ("fedavg_s", "adaptcl")
    lam = sim.lam if sparse else 0.0
    unit_map = env.unit_map
    base_shapes = env.base_shapes
    flat = flatten_unit_space(env.space)
    U = flat.num_units
    byz_cfg, ch_cfg, corrupt_on, rb_cfg, robust_on = _robust_statics(sim)
    quar_cfg = rb_cfg.quarantine if rb_cfg is not None else None
    quarantined_commits = 0
    mesh = sim.mesh
    if mesh is not None and mesh.device.type != dev.type:
        raise ValueError(f"SimConfig.mesh lives on {mesh.device.type} ({mesh.backend}) but "
                         f"SimConfig.device is {sim.device!r}")

    scen = ScenarioEngine(sim.scenario, W) if sim.scenario is not None else None
    if scen is not None:
        plan_all = scen.draw_all(sim.rounds, shard_sizes=[len(s) for s in env.shards],
                                 train_len=len(env.task.y_train))
    else:
        plan_all = ScenarioPlan.full(sim.rounds, W)

    shard_x, shard_y = zip(*(env.shard_xy(w) for w in range(W)))
    state = env.fleet.init_state(
        env.base_params, list(shard_x), list(shard_y),
        sharding=fleet_sharding(mesh, sim.fleet_axis) if mesh is not None else None)
    # on a mesh this rank holds the global slots [lo, hi)
    lo, hi = state.row_offset, state.row_offset + state.w_local
    own = slice(lo, hi)
    if sim.resident_momentum:
        env.fleet.init_momentum(state)

    batch = sim.batch_size
    pad_a = max(plan_steps(len(env.shards[w]), batch, sim.local_epochs) for w in range(W))
    pad_b = max(plan_steps(len(env.shards[w]), batch, (1 - sim.beta) * sim.local_epochs)
                for w in range(W))
    K_pad = sim.round_fusion if sim.round_fusion > 0 else (sim.prune_interval if adapt else 8)
    K_pad = max(1, min(K_pad, sim.rounds))

    global_params = dict(env.base_params)
    sizes_dev = torch.as_tensor(np.asarray([len(s) for s in env.shards], np.int64)[own],
                                device=dev)
    dgc_res_dev = (
        {k: torch.zeros((hi - lo,) + tuple(s), dtype=torch.float32, device=dev)
         for k, s in base_shapes.items()}
        if use_dgc else {}
    )

    indices = [full_index(env.space) for _ in range(W)]
    histories = [WorkerHistory() for _ in range(W)]
    pending_rates = [0.0] * W
    cig_scores = None
    interval_phis: List[List[float]] = [[] for _ in range(W)]
    prune_round_count = 0
    prune_events = []
    fused_chunks = 0

    clock = 0.0
    comm_bytes = 0.0
    server_overhead = 0.0
    acc_time, het_traj, sim_traj, upd_times = [], [], [], []
    scen_rows = []

    # payload bytes and FLOPs depend on an index only through its per-layer
    # retained counts: one shape walk per distinct count vector
    _count_cache: Dict[tuple, tuple] = {}

    def _bytes_flops(idx) -> tuple:
        key = tuple(len(idx[name]) for name in flat.names)
        ent = _count_cache.get(key)
        if ent is None:
            shapes = subparam_shapes(idx, unit_map, base_shapes)
            ent = (sum(int(np.prod(s)) * 4 for s in shapes.values()),
                   cnn_flops_from_shapes(shapes, sim.cnn))
            _count_cache[key] = ent
        return ent

    acc_time.append((0.0, _env_accuracy(env, global_params)))
    rt_base = roundtrip_total()

    robust = None
    if robust_on:
        robust = (byz_cfg is not None, corrupt_on, int(sim.seed),
                  _robust_step_kwargs(byz_cfg, ch_cfg, corrupt_on, rb_cfg))
    sig = (tuple(sorted((k, tuple(v.shape)) for k, v in state.params.items())),
           ("fused", K_pad, pad_a, pad_b, tuple(state.xs.shape), batch, sim.aggregation,
            sim.importance, bool(sim.resident_momentum), float(sim.dgc_sparsity),
            None if robust is None else repr(robust),
            None if mesh is None else (sim.fleet_axis, mesh.size)), float(lam))
    chunk_fn = _SyncChunk(
        env.trainer, unit_map, base_shapes, flat, lam,
        by_unit=sim.aggregation == "by_unit", importance=sim.importance,
        resident_momentum=bool(sim.resident_momentum), has_phase_b=pad_b > 0,
        dgc_sparsity=float(sim.dgc_sparsity), device=dev, robust=robust,
        mesh=mesh, full_rows=W if mesh is not None else None,
    )
    # the quarantine's health carry: [W] strikes and probation rows
    health_dev = ({"strikes": torch.zeros(W, dtype=torch.int32, device=dev),
                   "quar": torch.zeros(W, dtype=torch.int32, device=dev)}
                  if quar_cfg is not None else {})

    t = 0
    while t < sim.rounds:
        # ---- chunk-start churn (host): replaced slots restart fresh
        ev0 = plan_all.events[t]
        if ev0.joined.any():
            joined = [int(w) for w in np.flatnonzero(ev0.joined)]
            for w in joined:
                indices[w] = full_index(env.space)
                histories[w] = WorkerHistory()
                pending_rates[w] = 0.0
                interval_phis[w] = []
                env.shards[w] = plan_all.fresh_shards[t][w]
                env.fleet.update_shard(state, w, *env.shard_xy(w))
                if use_dgc:     # a fresh slot carries no residual
                    for r in state.local_rows([w]):
                        for v in dgc_res_dev.values():
                            v[r] = 0.0
            env.fleet.zero_momentum_rows(state, joined)
        # ---- FedDST readjustment at the chunk boundary (host): a regrow
        # round always opens a chunk; the broadcast-back re-masks the
        # params, the momentum drops the removed units here
        if _regrow_round(sim, t + 1):
            regrown = _regrow_step(sim, env, global_params, indices, t + 1)
            for w, idx_w in regrown:
                prune_events.append((t + 1, int(w), {k: tuple(map(int, v))
                                                     for k, v in idx_w.items()}))
            if regrown and sim.resident_momentum:
                pres_now = torch.as_tensor(np.stack([presence_from_index(indices[w], flat)
                                                     for w in range(lo, hi)]), device=dev)
                m_now = masks_from_presence(pres_now, flat, unit_map, base_shapes)
                state.momentum = {k: v * m_now[k] for k, v in state.momentum.items()}
        # ---- chunk extent: learning events, churn, regrow and drift-change
        # rounds cut (a drift-change round ends its chunk, so the re-learning
        # runs at the boundary where the lazy loop runs it)
        n = min(K_pad, sim.rounds - t)
        if adapt:
            n = min(n, sim.prune_interval - (t % sim.prune_interval))
        for j in range(1, n):
            if (plan_all.events[t + j].joined.any() or _regrow_round(sim, t + j + 1)
                    or (scen is not None and scen.drift_changed(t + j))):
                n = j
                break
        rounds_this = list(range(t + 1, t + n + 1))

        # ---- host pre-compute: plans, budgets, jitter, in the lazy loop's
        # env.rng order (plans, then jitter, per round)
        plans_a = np.zeros((K_pad, W, pad_a, batch), np.int64)
        valid_a = np.zeros((K_pad, W, pad_a), np.float32)
        plans_b = np.zeros((K_pad, W, max(pad_b, 1), batch), np.int64)
        valid_b = np.zeros((K_pad, W, max(pad_b, 1)), np.float32)
        budgets = np.zeros((K_pad, W), np.int64)
        prune_any = np.zeros((K_pad,), bool)
        real = np.zeros((K_pad,), bool)
        weights = np.zeros((K_pad, W), np.float32)
        submit_m = np.zeros((K_pad, W), np.float32)
        mult_m = np.zeros((K_pad, W), np.float32)
        byz_m = np.zeros((K_pad, W), bool)
        cor_m = np.zeros((K_pad, W), bool)
        rnd_arr = np.zeros((K_pad,), np.int64)
        jitters = np.ones((K_pad, W))
        recov = np.zeros((K_pad, W), np.float32)
        drmat = np.ones((K_pad, W))
        steps_a = np.zeros((K_pad, W), np.int64)
        steps_b = np.zeros((K_pad, W), np.int64)
        active_list: List[List[int]] = []
        prune_now_rounds: List[np.ndarray] = []
        eval_rounds = set()

        for j, rnd in enumerate(rounds_this):
            ev = plan_all.events[rnd - 1]
            active_ws = [int(w) for w in np.flatnonzero(ev.active)]
            active_list.append(active_ws)
            if rnd % sim.eval_every == 0:
                eval_rounds.add(j)
            if scen is not None:
                scen_rows.append((rnd, len(active_ws), int(ev.dropped.sum()),
                                  int(ev.joined.sum())))
            # crash recovery: applies on skipped rounds too (the lazy loop
            # resets before it skips)
            if ev.recovered is not None:
                recov[j] = ev.recovered.astype(np.float32)
            if (scen is not None and scen.cfg.faults is not None
                    and scen.cfg.faults.drift is not None):
                drmat[j] = scen.drift_mults(rnd)
            if ev.skip:
                # too few survivors: no plans, no jitter, no rate reset, as
                # in the lazy loop's skip branch
                prune_now_rounds.append(np.zeros(W, bool))
                continue
            pa: List[Optional[np.ndarray]] = [None] * W
            pb: List[Optional[np.ndarray]] = [None] * W
            pn = np.zeros(W, bool)
            for w in active_ws:
                rate = pending_rates[w] if adapt else 0.0
                if adapt and rate > 0.0:
                    e1 = sim.beta * sim.local_epochs
                    e2 = (1 - sim.beta) * sim.local_epochs
                    pn[w] = True
                else:
                    e1, e2 = sim.local_epochs, 0.0
                nsh = len(env.shards[w])
                pa[w] = make_batch_plan(nsh, batch, e1, env.rng)
                pb[w] = make_batch_plan(nsh, batch, e2, env.rng)
                steps_a[j, w] = pa[w].shape[0]
                steps_b[j, w] = pb[w].shape[0]
            prune_now_rounds.append(pn)
            for w in active_ws:
                if pn[w]:
                    budgets[j, w] = prune_budget_units(indices[w], pending_rates[w], env.space)
            prune_any[j] = bool(pn.any())
            sa = stack_batch_plans(pa, num_rows=W, num_steps=pad_a)
            if sa is not None:
                plans_a[j], valid_a[j] = sa
            if pad_b > 0:
                sb = stack_batch_plans(pb, num_rows=W, num_steps=pad_b)
                if sb is not None:
                    plans_b[j], valid_b[j] = sb
            submit_m[j] = ev.submitters.astype(np.float32)
            # commit multiplicity: the submitter indicator without a channel
            mult_j = _commit_multiplicity(ev)
            mult_m[j] = mult_j.astype(np.float32)
            if sim.aggregation != "by_unit" and mult_j.sum() > 0:
                weights[j] = (mult_j / mult_j.sum()).astype(np.float32)
            if ev.byz is not None:
                byz_m[j] = ev.byz & ev.submitters
            if corrupt_on and ev.corrupt is not None:
                cor_m[j] = ev.corrupt & ev.delivered & ev.submitters
            rnd_arr[j] = rnd
            real[j] = True
            if sim.time_jitter > 0:
                for w in active_ws:
                    jitters[j, w] = float(np.exp(env.rng.normal(0, sim.time_jitter)))
            for w in active_ws:      # submission resets the pending rate
                pending_rates[w] = 0.0

        orders_np = None
        if sim.importance in STATIC_METHODS:
            orders_np = _static_orders(sim, env, flat, cig_scores, prune_round_count)
        # the chunk takes this rank's rows: [W, ...] state and orders on dim
        # 0, [K, W, ...] per-round inputs on dim 1; prune_any, real and rnd
        # are the whole fleet's
        orders_dev = torch.as_tensor(
            (orders_np if orders_np is not None else np.zeros((W, U), np.int32))[own]
            .astype(np.int64), device=dev)
        presence_dev = torch.as_tensor(
            np.stack([presence_from_index(indices[w], flat) for w in range(lo, hi)]), device=dev)
        per_round = {
            "plan_a": torch.as_tensor(plans_a[:, own], device=dev),
            "valid_a": torch.as_tensor(valid_a[:, own], device=dev),
            "budgets": torch.as_tensor(budgets[:, own], device=dev),
            "weights": torch.as_tensor(weights[:, own], device=dev),
            "submitters": torch.as_tensor(submit_m[:, own], device=dev),
            "recov": torch.as_tensor(recov[:, own], device=dev),
        }
        if pad_b > 0:
            per_round["plan_b"] = torch.as_tensor(plans_b[:, own], device=dev)
            per_round["valid_b"] = torch.as_tensor(valid_b[:, own], device=dev)
        flags = {"prune_any": prune_any, "real": real, "recov_any": recov[:, own].any(axis=1),
                 "byz": byz_m[:, own], "corrupt": cor_m[:, own], "rnd": rnd_arr}
        if robust_on:
            per_round["mult"] = torch.as_tensor(mult_m[:, own], device=dev)
        momentum_arg = state.momentum if sim.resident_momentum else {}

        # ---- ONE counted dispatch for the whole chunk
        (state.params, mom_out, _, global_dev, dgc_res_dev, health_dev, pres_seq, evals,
         kept_seq, total_seq, quar_seq) = env.trainer.dispatch(
            sig, chunk_fn, state.params, momentum_arg, presence_dev, global_params,
            dgc_res_dev, health_dev, state.xs, state.ys, sizes_dev, per_round, flags,
            orders_dev, n, eval_rounds, RUN_DEAD_ROUNDS,
        )
        if sim.resident_momentum:
            state.momentum = mom_out
        fused_chunks += 1
        env.fleet.batched_calls += 1
        env.fleet.buckets_used.add(W)

        if mesh is not None:
            # every rank does the accounting on the whole fleet's trails
            # (the quarantine trail is already the fleet's)
            trails = all_gather_fleet({"pres": pres_seq, "kept": kept_seq, "total": total_seq}
                                      if use_dgc else {"pres": pres_seq}, mesh, dim=1)
            pres_seq = trails["pres"]
            if use_dgc:
                kept_seq, total_seq = trails["kept"], trails["total"]
        pres_seq_np = pres_seq.cpu().numpy()                    # [n, W, U]
        if use_dgc:                                             # [n, W] ints
            kept_np = kept_seq.cpu().numpy()
            total_np = total_seq.cpu().numpy()
        if quar_cfg is not None:                                # [n, W] bools
            quar_np = quar_seq.cpu().numpy()

        # ---- post-chunk host accounting (ledger, payloads, clock, evals)
        for j, rnd in enumerate(rounds_this):
            ev = plan_all.events[rnd - 1]
            active_ws = active_list[j]
            pn = prune_now_rounds[j]
            if ev.skip:
                # the global passes through untouched; the clock waits out
                # the straggler deadline; evals still fire
                clock += _skip_round_time(env, scen, indices, rnd)
                upd_times.append([float("nan")] * W)
                if j in eval_rounds:
                    acc_time.append((clock, _env_accuracy(env, evals[j])))
                continue
            for w in active_ws:     # ledger phase A at the pre-prune index
                env.account_train(indices[w], int(steps_a[j, w]))
            for w in active_ws:
                if pn[w]:
                    indices[w] = index_from_presence(pres_seq_np[j, w], flat)
                    prune_events.append((rnd, int(w), {k: tuple(map(int, v))
                                                       for k, v in indices[w].items()}))
                    if pad_b > 0:   # ledger phase B at the pruned index
                        env.account_train(indices[w], int(steps_b[j, w]))
            if quar_cfg is not None:
                # commits the server excluded: a quarantined row whose
                # payload arrived
                quarantined_commits += int((quar_np[j] & (mult_m[j] > 0)).sum())
            phis = np.full(W, np.nan)
            for w in active_ws:
                bytes_w, flops_w = _bytes_flops(indices[w])
                # the host path's DGC payload factor from the device's
                # realized kept/total counts (non-submitters pay in full)
                pf = 1.0
                if use_dgc and ev.submitters[w]:
                    pf = 1.25 * float(kept_np[j, w]) / max(float(total_np[j, w]), 1.0)
                # jitter x (drift x retries) as one product: the lazy loop's
                # float grouping
                retry_mult = 1.0
                if ch_cfg is not None and ev.retries is not None and ev.submitters[w]:
                    retry_mult = 1.0 + ch_cfg.retry_backoff * float(ev.retries[w])
                phi_w = env.phi_from_cost(w, bytes_w, flops_w, pf,
                                          jitters[j, w] * (drmat[j, w] * retry_mult))
                phis[w] = phi_w
                interval_phis[w].append(phi_w)
                if ev.submitters[w]:
                    extra = 0.0
                    if ch_cfg is not None and ev.retries is not None:
                        extra = (float(ev.retries[w])
                                 + float(ev.dup[w] & ev.delivered[w])) * pf * bytes_w
                    comm_bytes += 2.0 * pf * bytes_w + extra
            sub_phis = phis[ev.submitters]
            round_time = float(sub_phis.max())
            if ev.dropped.any() and scen is not None:
                round_time *= scen.cfg.timeout_factor
            clock += round_time
            upd_times.append(list(phis))
            het_traj.append((rnd, heterogeneity_from_times(sub_phis)))
            if W > 3:
                sim_traj.append((rnd, similarity(indices[1], indices[3])))
            if j in eval_rounds:
                acc_time.append((clock, _env_accuracy(env, evals[j])))
        global_params = global_dev
        t += n

        # ---- learning event at the chunk boundary (host Newton math); a
        # drift change always ends its chunk, so it fires one round after
        # the capability changed, as in the lazy loop
        drift_now = scen is not None and scen.drift_changed(t)
        if adapt and (t % sim.prune_interval == 0 or drift_now):
            t0 = _time.perf_counter()
            prune_round_count += 1
            if cig_scores is None and sim.importance == "cig_bnscalor":
                cig_scores = METHODS["cig_bnscalor"](ImportanceContext(
                    unit_counts=env.space.unit_counts,
                    scales=extract_bn_scales(global_params, sim.cnn),
                ))
            if drift_now:
                histories[sim.scenario.faults.drift.worker].invalidate()
            mults = scen.drift_mults(t) if scen is not None else np.ones(W)
            gammas_now = [retention(indices[w], env.space) for w in range(W)]
            phis_now = [
                float(np.mean(interval_phis[w])) if interval_phis[w]
                else env.phi_from_index(w, indices[w], jitter=False, time_mult=float(mults[w]))
                for w in range(W)
            ]
            for w in range(W):
                histories[w].record(gammas_now[w], phis_now[w])
            if sim.fixed_pruned_rates is not None:
                k = prune_round_count - 1
                rates = (sim.fixed_pruned_rates[k] if k < len(sim.fixed_pruned_rates)
                         else [0.0] * W)
            else:
                rates = learn_pruned_rates(histories, gammas_now, phis_now, sim.rate_cfg)
            pending_rates = list(rates)
            interval_phis = [[] for _ in range(W)]
            server_overhead += _time.perf_counter() - t0

    host_roundtrips = roundtrip_total() - rt_base
    final_costs = [env.cost_for_index(indices[w]) for w in range(W)]
    return _finalize(
        sim, env, acc_time, het_traj, sim_traj, upd_times,
        [retention(indices[w], env.space) for w in range(W)],
        [extract_subparams(global_params, indices[w], unit_map) for w in range(W)],
        comm_bytes, server_overhead, clock,
        global_params=global_params, host_roundtrips=host_roundtrips,
        flops_per_image_final=float(np.mean([c[0] for c in final_costs])),
        blocks_per_image_final=float(np.mean([c[2] for c in final_costs])),
        prune_events=prune_events, scenario_rounds=scen_rows,
        fault_ledger={**fault_ledger(plan_all.events),
                      "quarantined_commits": quarantined_commits},
        fused_chunks=fused_chunks,
    )


# ---------------------------------------------------------------------------
# fused async engine: the event queue as chunks of window batches
# ---------------------------------------------------------------------------

def split_time_keys(finishes: np.ndarray):
    """Float64 finish times as two float32 sort keys: ``hi`` is the float32
    rounding, ``lo`` the float64 residual in float32.  Rounding is monotone,
    so ``(hi, lo)`` order is float64 order except for residual-level
    collisions, which the per-chunk plan check turns into an error."""
    hi = finishes.astype(np.float32)
    lo = (finishes - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def async_pop_perm(fin_hi: torch.Tensor, fin_lo: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The device pending-queue pop: ``jnp.lexsort((rows, fin_lo, fin_hi))``
    as three stable sorts, least significant key first.  Finish time first,
    ties in ascending worker order (the host heap's ``(time, worker)``
    order); padding slots carry ``hi = +inf`` and sort last."""
    perm = torch.sort(rows, stable=True).indices
    perm = perm[torch.sort(fin_lo[perm], stable=True).indices]
    return perm[torch.sort(fin_hi[perm], stable=True).indices]


class _AsyncChunk:
    """The window-batch body of the async chunk, applied to the batches of
    one chunk.  Carry: fetched ``[W, ...]`` snapshots, the global, the
    server version, per-slot fetched versions, DC-ASGD's backup rows and
    mean-square accumulator, and the quarantine's health (strikes,
    probation, last norm and seen per slot, the rejected count).  Returns
    the carry, the popped worker order and staleness ``[nb, BP]``
    (positions past a batch's events hold -1), and the globals after each
    eval commit."""

    def __init__(self, trainer, unit_map, base_shapes, lam, *, method, BP, cohort_size,
                 fedasync_a, lr, dcasgd_lambda, dcasgd_m, device, clip_norm=None,
                 quarantine=None):
        self.trainer = trainer
        self.unit_map = unit_map
        self.lam = lam
        self.method = method
        self.BP = BP
        self.quarantine = quarantine
        self.kw = dict(cohort_size=cohort_size, fedasync_a=fedasync_a, lr=lr,
                       dcasgd_lambda=dcasgd_lambda, dcasgd_m=dcasgd_m, clip_norm=clip_norm)
        # async workers never prune: all-ones masks, base-shape group-lasso
        self.masks = {k: torch.ones((BP,) + tuple(s), dtype=torch.float32, device=device)
                      for k, s in base_shapes.items()}
        self.gl = {lname: torch.full((BP,), s, dtype=torch.float32, device=device)
                   for lname, s in group_size_sqrt_from_shapes(base_shapes, unit_map).items()}

    def health_step(self, health, t_row, f_row, w):
        """The commit's quarantine verdict on its unclipped delta norm; a
        rejected commit keeps the global (the version still bumps)."""
        q = self.quarantine
        norm = delta_norms_dev({k: (t_row[k] - f_row[k]).unsqueeze(0) for k in t_row})[0]
        reject, st2, qu2, nm2, sn2 = async_health_step_dev(
            norm, w[0], health["strikes"], health["quar"], health["norms"], health["seen"],
            threshold=q.threshold, strikes_needed=q.strikes, probation=q.probation)
        health = {"strikes": st2, "quar": qu2, "norms": nm2, "seen": sn2,
                  "rejected": health["rejected"] + reject.to(torch.int32)}
        return health, reject

    def __call__(self, fetched, g, version, fetched_ver, backup, dc_m, health, xs, ys,
                 per_batch, lengths, eval_pos):
        order_seq, stale_seq = [], []
        evals: Dict[tuple, Tensors] = {}
        BP = self.BP
        for j, L in enumerate(lengths):
            perm = async_pop_perm(per_batch["fin_hi"][j], per_batch["fin_lo"][j],
                                  per_batch["rows"][j])
            rows = per_batch["rows"][j][perm]
            dropped = per_batch["dropped"][j][perm]
            refetch = per_batch["refetch"][j][perm]
            plans = per_batch["plans"][j][perm]
            pvalid = per_batch["pvalid"][j][perm]
            # each popped worker trains from its fetched snapshot: one
            # stack for the batch (its workers are distinct, and each input
            # was fixed at its last refetch)
            p0 = {k: v.index_select(0, rows) for k, v in fetched.items()}
            trained, _, _ = self.trainer._train_stack(
                p0, self.masks, self.unit_map, xs.index_select(0, rows),
                ys.index_select(0, rows), plans, pvalid, self.lam, self.gl, None)
            order = torch.full((BP,), -1, dtype=torch.int64, device=rows.device)
            stale = torch.full((BP,), -1, dtype=torch.int64, device=rows.device)
            for i in range(L):     # the batch's events sort first, padding last
                w = rows[i : i + 1]
                s = version - fetched_ver.index_select(0, w)[0]
                t_row = {k: v[i] for k, v in trained.items()}
                f_row = {k: v[i] for k, v in p0.items()}
                b_row = {k: v.index_select(0, w)[0] for k, v in backup.items()}
                g2, dc_m2 = async_commit_dev(self.method, g, t_row, f_row, s, b_row, dc_m,
                                             **self.kw)
                live = dropped[i] == 0
                keep = live
                if self.quarantine is not None:
                    # only merged commits move the tracker: a dropped
                    # commit leaves it as it was
                    h2, reject = self.health_step(health, t_row, f_row, w)
                    health = {k: torch.where(live, h2[k], health[k]) for k in health}
                    keep = live & ~reject
                g = {k: torch.where(keep, g2[k], g[k]) for k in g}
                if backup:
                    for k, v in backup.items():
                        v.index_copy_(0, w, torch.where(keep, g2[k], b_row[k]).unsqueeze(0))
                    dc_m = {k: torch.where(keep, dc_m2[k], dc_m[k]) for k in dc_m}
                version = version + live.long()
                # refetch after the bump: a dropped commit refetches the
                # unchanged global
                fetched = refetch_rows(fetched, refetch[i], g)
                fetched_ver = torch.where(refetch[i] > 0, version, fetched_ver)
                order[i] = w[0]
                stale[i] = s
                if (j, i) in eval_pos:
                    evals[(j, i)] = g
            order_seq.append(order)
            stale_seq.append(stale)
        return (fetched, g, version, fetched_ver, backup, dc_m, health, torch.stack(order_seq),
                torch.stack(stale_seq), evals)


def run_async_fused(sim, env, scen, participants, plan):
    """Async simulation on the fused event-queue engine (see the module
    doc): replays the same ``AsyncEventPlan`` as the other engines, so the
    commit order, staleness, dropout outcomes and clocks are theirs."""
    from .simulation import _env_accuracy, _finalize   # deferred: simulation routes here

    W = sim.num_workers
    dev = env.device
    method = sim.method
    n_part = len(participants)
    idx = full_index(env.space)
    # the robust layer's async half: clip and quarantine (the trimmed mean
    # is refused for async methods)
    rb_cfg = sim.robust if sim.robust is not None and sim.robust.any_active else None
    clip_norm = rb_cfg.clip if rb_cfg is not None else None
    quar_cfg = rb_cfg.quarantine if rb_cfg is not None else None

    global_params = dict(env.base_params)
    acc_time = [(0.0, _env_accuracy(env, global_params))]
    rt_base = roundtrip_total()
    # async commits move base-shape payloads (workers never prune)
    commit_bytes = 2.0 * sum(int(np.prod(s)) * 4 for s in env.base_shapes.values())
    comm_bytes = 0.0
    fused_chunks = 0
    final_cost = env.cost_for_index(idx)
    scen_rows = [(0, n_part, 0, 0)] if scen is not None else []

    E = plan.num_events
    if E == 0:
        return _finalize(sim, env, acc_time, [], [], [], [1.0] * W, [global_params] * W, 0.0,
                         0.0, 0.0, global_params=global_params,
                         host_roundtrips=roundtrip_total() - rt_base,
                         flops_per_image_final=final_cost[0],
                         blocks_per_image_final=final_cost[2], prune_events=[],
                         scenario_rounds=scen_rows,
                         fault_ledger={**(plan.fault_ledger or {}), "quarantined_commits": 0},
                         fused_chunks=0)

    shard_x, shard_y = zip(*(env.shard_xy(w) for w in range(W)))
    state = env.fleet.init_state(env.base_params, list(shard_x), list(shard_y))

    batch = sim.batch_size
    pad_steps = max(plan_steps(len(env.shards[w]), batch, sim.local_epochs)
                    for w in participants)
    S_eff = max(pad_steps, 1)      # a step dim even for no-step plans
    n_batches = len(plan.batch_starts) - 1
    BP = int(np.diff(plan.batch_starts).max())
    KB = sim.round_fusion if sim.round_fusion > 0 else 8
    KB = max(1, min(KB, n_batches))
    fin_hi_all, fin_lo_all = split_time_keys(plan.finishes)

    g_dev = {k: v.float() for k, v in global_params.items()}
    fetched_dev = state.params     # [W, ...] broadcast of the base params
    version_dev = torch.zeros((), dtype=torch.int64, device=dev)
    fetched_ver_dev = torch.zeros(W, dtype=torch.int64, device=dev)
    if method == "dcasgd_s":
        backup_dev = {k: v.clone() for k, v in fetched_dev.items()}   # w_bak starts at g
        dc_m_dev = {k: torch.zeros_like(v) for k, v in g_dev.items()}
    else:
        backup_dev, dc_m_dev = {}, {}
    health_dev = ({"strikes": torch.zeros(W, dtype=torch.int32, device=dev),
                   "quar": torch.zeros(W, dtype=torch.int32, device=dev),
                   "norms": torch.zeros(W, dtype=torch.float32, device=dev),
                   "seen": torch.zeros(W, dtype=torch.bool, device=dev),
                   "rejected": torch.zeros((), dtype=torch.int32, device=dev)}
                  if quar_cfg is not None else {})

    rb_sig = (None if clip_norm is None else float(clip_norm),
              None if quar_cfg is None else (float(quar_cfg.threshold), int(quar_cfg.strikes),
                                             int(quar_cfg.probation)))
    sig = (tuple(sorted((k, tuple(v.shape)) for k, v in state.params.items())),
           ("fused_async", method, KB, BP, S_eff, tuple(state.xs.shape), batch, n_part,
            float(sim.fedasync_a), float(sim.lr), float(sim.dcasgd_lambda),
            float(sim.dcasgd_m), rb_sig),
           float(sim.lam))
    chunk_fn = _AsyncChunk(
        env.trainer, env.unit_map, env.base_shapes, sim.lam, method=method, BP=BP,
        cohort_size=n_part, fedasync_a=float(sim.fedasync_a), lr=float(sim.lr),
        dcasgd_lambda=float(sim.dcasgd_lambda), dcasgd_m=float(sim.dcasgd_m), device=dev,
        clip_norm=None if clip_norm is None else float(clip_norm), quarantine=quar_cfg,
    )

    b = 0
    while b < n_batches:
        nc = min(KB, n_batches - b)
        rows_a = np.zeros((nc, BP), np.int64)
        drop_a = np.zeros((nc, BP), np.float32)
        # padding slots: +inf finish keys sort them after every event
        hi_a = np.full((nc, BP), np.inf, np.float32)
        lo_a = np.zeros((nc, BP), np.float32)
        plans_a = np.zeros((nc, BP, S_eff, batch), np.int64)
        pvalid_a = np.zeros((nc, BP, S_eff), np.float32)
        ref_a = np.zeros((nc, BP, W), np.float32)
        lengths = []
        eval_pos = set()
        for j in range(nc):
            s0 = int(plan.batch_starts[b + j])
            e0 = int(plan.batch_starts[b + j + 1])
            L = e0 - s0
            lengths.append(L)
            # the device queue is fed in heap PUSH order: its pop must
            # re-derive the commit order
            feed = s0 + np.argsort(plan.push_seq[s0:e0], kind="stable")
            rows_a[j, :L] = plan.workers[feed]
            drop_a[j, :L] = plan.dropped[feed]
            hi_a[j, :L] = fin_hi_all[feed]
            lo_a[j, :L] = fin_lo_all[feed]
            ref_a[j, :L] = plan.refetch[feed]
            for r, i in enumerate(feed):
                p = plan.plans[i]
                if p.shape[0]:
                    plans_a[j, r, : p.shape[0]] = p
                    pvalid_a[j, r, : p.shape[0]] = 1.0
            # evals fire after every n_part-th commit: a position in commit
            # order, whoever commits there
            for i in range(s0, e0):
                if plan.evals[i]:
                    eval_pos.add((j, i - s0))
        per_batch = {
            "rows": torch.as_tensor(rows_a, device=dev),
            "dropped": torch.as_tensor(drop_a, device=dev),
            "fin_hi": torch.as_tensor(hi_a, device=dev),
            "fin_lo": torch.as_tensor(lo_a, device=dev),
            "plans": torch.as_tensor(plans_a, device=dev),
            "pvalid": torch.as_tensor(pvalid_a, device=dev),
            "refetch": torch.as_tensor(ref_a, device=dev),
        }

        # ---- ONE counted dispatch for the whole chunk
        (fetched_dev, g_dev, version_dev, fetched_ver_dev, backup_dev, dc_m_dev, health_dev,
         order_seq, stale_seq, evals) = env.trainer.dispatch(
            sig, chunk_fn, fetched_dev, g_dev, version_dev, fetched_ver_dev, backup_dev,
            dc_m_dev, health_dev, state.xs, state.ys, per_batch, lengths, eval_pos,
        )
        fused_chunks += 1
        env.fleet.batched_calls += 1
        env.fleet.buckets_used.add(BP)

        order_np = order_seq.cpu().numpy()
        stale_np = stale_seq.cpu().numpy()
        for j in range(nc):
            s0 = int(plan.batch_starts[b + j])
            e0 = int(plan.batch_starts[b + j + 1])
            L = e0 - s0
            # the device pop must reproduce the host heap replay exactly:
            # commit order (ties included) and staleness integers
            if not (np.array_equal(order_np[j, :L], plan.workers[s0:e0])
                    and np.array_equal(stale_np[j, :L], plan.staleness[s0:e0])):
                raise RuntimeError("device event queue diverged from host heap replay")
            for i in range(s0, e0):
                env.account_train(idx, plan.plans[i].shape[0])
                if not plan.dropped[i]:
                    comm_bytes += commit_bytes
                if plan.evals[i]:
                    acc_time.append((float(plan.clocks[i]),
                                     _env_accuracy(env, evals[(j, i - s0)])))
        b += nc

    clock = float(plan.clocks[-1])
    rejected = int(health_dev["rejected"]) if quar_cfg is not None else 0
    return _finalize(
        sim, env, acc_time, [], [], [], [1.0] * W, [g_dev] * W, comm_bytes, 0.0, clock,
        global_params=g_dev, host_roundtrips=roundtrip_total() - rt_base,
        flops_per_image_final=final_cost[0], blocks_per_image_final=final_cost[2],
        prune_events=[], scenario_rounds=scen_rows,
        fault_ledger={**(plan.fault_ledger or {}), "quarantined_commits": rejected},
        fused_chunks=fused_chunks,
    )
