"""Multi-worker collaborative-learning simulator (AdaptCL §IV), on PyTorch.

Port of ``repro/core/simulation.py``, all six frameworks:

  * ``adaptcl``    — Algorithm 1 driven by Algorithm 2 pruned-rate learning
  * ``fedavg``     — McMahan et al. BSP
  * ``fedavg_s``   — + group-lasso sparse training
  * ``fedasync_s`` — Xie et al. async with polynomial staleness weighting
  * ``ssp_s``      — stale-synchronous parallel (threshold ``ssp_threshold``)
  * ``dcasgd_s``   — DC-ASGD-a (delay-compensated async gradients)

W workers with heterogeneous bandwidths (the Eq. 6/7 channel model) train
pruned copies of a VGG or ResNet.  ``SimConfig.engine`` picks how
(``core.fleet``):

  * ``"sequential"`` (the default, as in the reference) — each worker holds
    a physically small sub-model, extracted from the global model, trained
    one call per worker, pruned by slicing, and embedded back for the
    float64 aggregation;
  * ``"bucketed"`` — the same, with same-shaped workers stacked into one
    call;
  * ``"masked"`` — the resident engine: ``[W, ...]`` base-shape stacks on
    the device, a sub-model is a 0/1 mask, pruning rewrites mask rows, and
    aggregation reads the stacks.  ``compute="block_skip"`` (masked only)
    sends every conv and the head through the hand-written block-skip CUDA
    kernel, so a pruned worker's device FLOPs follow its retention;
    ``compute="dense"`` runs grouped convs at base shape (the oracle).
  * ``"fused"`` — the resident stacks with whole rounds on the device:
    chunks of rounds between learning events run without a host boundary
    (device prune greedy, DGC and float32 aggregation), and the async event
    queue runs as chunks of window batches (``core.fused``); dense only.

Importance is a static criterion (cig_bnscalor, index, no_adjacent,
no_identical, no_constant) or a data-dependent one (l1, taylor, fpgm, hrank),
scored on the worker's own trained sub-model and shard at its pruning event.

The fleet need not be whole or still (``SimConfig.scenario``,
``core.scenario``): per-round client sampling, straggler dropout with the
server's timeout, churn (a slot restarts as a fresh worker on a fresh
shard), explicit schedules, Dirichlet label skew, and the ``core.faults``
families drift, crash/recovery, regional outage, participation wave,
byzantine workers and a lossy channel.  A round whose fault survivors fall
below ``min_participants`` is skipped: the clock waits out the straggler
deadline and nothing trains.  Under the byzantine and channel families, or
with ``SimConfig.robust`` (clip, trimmed mean, quarantine), every sync
engine aggregates through ``aggregation.robust_submission_step_dev`` on
``[W, ...]`` stacks (the per-worker engines embed their submissions into
base-shape stacks first), and a channel retry stretches the worker's update
time and re-sends its upload.  On the resident
engine a partial cohort trains as a power-of-two row bucket gathered from
the stacks.  ``dgc_sparsity`` commits only the largest deltas at the
submission boundary (DGC, host numpy as in the reference), and
``resident_momentum`` carries the masked engine's momentum across phases
and rounds.  ``regrow`` (``RegrowConfig``, sync methods) readjusts each
pruned worker's mask every few rounds, FedDST-style: shrink by the global's
weight magnitude, grow the same parameter mass back by dense-gradient
magnitude, at the round start so grown units take the global's values.

The async schedulers' event timeline does not depend on trained params
(async workers never prune; SSP blocks on commit counts), so
``_plan_async_events`` replays the whole heap loop on the host first into a
``scenario.AsyncEventPlan`` and every engine replays that one plan.  Commits
landing within ``async_window`` virtual seconds train as one fleet call: on
the resident engine each committing row takes the global snapshot it
fetched (``FleetEngine.scatter_global_rows``), the batch trains as one
bucket-sized sub-stack and comes back in one host copy; the per-commit
merges are ``aggregation.AsyncServer``'s, host numpy.  Async runs honour
client sampling (a static cohort), dropout (a timed-out commit trains but
is not merged), crash faults, and the robust layer's per-commit clip and
quarantine; the sync-only families and the trimmed mean are refused.

All host randomness is numpy and is consumed in the reference's order (batch
plans per active worker, then one jitter draw per active worker; the
scenario and fault streams in ``core.scenario``; the async planner's order
in ``_plan_async_events``), so the virtual clock and the prune events equal
the JAX package's for the same seed.  The JAX
package draws its init from ``jax.random``; pass that init as
``run_simulation(sim, base_params=...)`` to start from the same weights
(otherwise ``init_cnn`` draws from a ``torch.Generator`` seeded with
``sim.seed``).

The fused sync engine also runs on a mesh-sharded fleet (``SimConfig.mesh``,
``fleet_axis``; ``launch.mesh``): one process per rank of a
``torch.distributed`` group, each holding ``W / n`` rows, every rank
returning the same result (``SimResult.n_devices``, ``fleet_axis_size``,
``shard_spec``).

The entry points run on the card: ``SimConfig.device`` defaults to
``"cuda"`` and raises when no card is present.  Configurations the
reference refuses raise ``ValueError`` naming the field.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import time as _time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.synthetic import SyntheticImageTask, partition_dirichlet, partition_noniid
from repro_torch.models.cnn import (
    CNNConfig,
    build_unit_space,
    cnn_apply,
    cnn_block_compute,
    cnn_flops,
    cnn_flops_from_shapes,
    extract_bn_scales,
    init_cnn,
    vgg_config,
)
from repro_torch.sharding.specs import fleet_pspec

from .aggregation import (
    AsyncServer,
    RobustAggConfig,
    aggregate_by_unit,
    aggregate_by_unit_stacked,
    aggregate_by_worker,
    aggregate_by_worker_stacked,
    coordinate_mask,
    embed_params,
    extract_subparams,
    noise_key,
    robust_submission_step_dev,
    roundtrip_total,
    subparam_shapes,
    tally_roundtrip,
)
from .faults import fault_ledger
from .fleet import ENGINES, FleetEngine, FleetJob
from .fused import run_async_fused, run_sync_fused, validate_fused_config
from .importance import DATA_DEPENDENT, METHODS, ImportanceContext, grad_magnitude_scores
from .masks import (
    full_index, payload_bytes, prune_to_budget, regrow_index, retention, similarity,
)
from .pruned_rate import PrunedRateConfig, WorkerHistory, learn_pruned_rates
from .scenario import AsyncEventPlan, ScenarioConfig, ScenarioEngine, full_participation
from .timing import HeterogeneityConfig, heterogeneity_from_times, make_bandwidths
from .worker import LocalTrainer, local_unit_stats, make_batch_plan, plan_steps

__all__ = ["SimConfig", "SimResult", "RegrowConfig", "run_simulation", "default_cnn",
           "validate_config"]

SYNC_METHODS = ("adaptcl", "fedavg", "fedavg_s")
ASYNC_METHODS = ("fedasync_s", "ssp_s", "dcasgd_s")


def default_cnn() -> CNNConfig:
    """Small VGG used by the CPU-budget simulations (same family as VGG16)."""
    return vgg_config("vgg_sim", [32, "M", 64, "M", 64], num_classes=10, image_size=16)


@dataclasses.dataclass(frozen=True)
class RegrowConfig:
    """FedDST-style mask readjustment (arXiv:2112.09824).

    Every ``interval`` rounds, each worker with retention < 1 prunes
    ``alpha_t`` of its retained parameters by the GLOBAL model's weight
    magnitude, then grows the same parameter budget back from its absent
    units, ranked by the gradient magnitude of the dense model at the
    global on the worker's own shard.  ``alpha_t`` follows FedDST's cosine
    anneal ``0.5 * alpha0 * (1 + cos(pi * (t-1) / T))`` (``"cosine"``) or
    stays ``alpha0`` (``"constant"``).  It happens at the START of a round,
    before broadcast-back, so grown units take the global's values."""

    interval: int = 4          # R_adj: rounds between mask readjustments
    alpha0: float = 0.3        # initial readjust fraction
    schedule: str = "cosine"   # "cosine" | "constant"

    def __post_init__(self):
        if self.interval < 1:
            raise ValueError(f"regrow interval {self.interval} must be >= 1")
        if not (0.0 < self.alpha0 < 1.0):
            raise ValueError(f"regrow alpha0 {self.alpha0} outside (0, 1)")
        if self.schedule not in ("cosine", "constant"):
            raise ValueError(f"regrow schedule {self.schedule!r} not in cosine/constant")


@dataclasses.dataclass
class SimConfig:
    method: str = "adaptcl"
    rounds: int = 30
    num_workers: int = 10
    local_epochs: float = 1.0
    batch_size: int = 32
    lr: float = 0.05
    lam: float = 1e-4                   # group-lasso coefficient (sparse train)
    prune_interval: int = 5             # PI
    beta: float = 1.0                   # pruning position within local epochs
    importance: str = "cig_bnscalor"
    aggregation: str = "by_worker"      # "by_worker" | "by_unit"
    rate_cfg: PrunedRateConfig = dataclasses.field(default_factory=PrunedRateConfig)
    het: HeterogeneityConfig = dataclasses.field(default_factory=HeterogeneityConfig)
    t_train_full: float = 1.0           # seconds per local round, full model
    train_sens: float = 0.1             # Appendix E: GPU-like ~0, CPU-like ~1
    time_jitter: float = 0.02
    noniid_s: float = 0.0               # paper's s%: 0 (IID) or 80
    ssp_threshold: int = 2
    fedasync_a: float = 0.5
    dcasgd_lambda: float = 2.0
    dcasgd_m: float = 0.95
    # async engines: commits landing within this virtual window train as
    # ONE fleet call (0.0 = serial)
    async_window: float = 0.0
    fixed_pruned_rates: Optional[List[List[float]]] = None  # Tab. IX mode
    # local-training engine: "sequential" | "bucketed" | "masked" (core.fleet)
    # | "fused" (core.fused)
    engine: str = "sequential"
    # fused engine: rounds (async: window batches) per chunk; 0 = until the
    # next learning event (adaptcl) or 8
    round_fusion: int = 0
    # AdaptCL+DGC (Appendix E / Tab. XVII): commit only the largest
    # (1-sparsity) fraction of each weight delta; the rest accumulates
    # locally until it crosses the threshold
    dgc_sparsity: float = 0.0
    # cross-round momentum: the resident engines' (masked, fused) momentum
    # stack is carried across phases and rounds instead of restarting per
    # phase
    resident_momentum: bool = False
    # client sampling / dropout / churn / skew / faults (core.scenario);
    # async methods take sampling, dropout and crash only
    scenario: Optional[ScenarioConfig] = None
    # FedDST mask regrowth (sync methods); None = monotone pruning only
    regrow: Optional[RegrowConfig] = None
    # robust server aggregation (aggregation.RobustAggConfig): per-commit
    # norm clip, coordinate-wise trimmed mean, MAD-outlier quarantine;
    # by_worker only, and the async methods take clip and quarantine only
    robust: Optional[RobustAggConfig] = None
    # the mesh-sharded fleet (fused sync engine only): a ``FleetMesh``
    # (launch.mesh.make_fleet_mesh) whose ``fleet_axis`` shards the [W, ...]
    # stacks over the ranks of a torch.distributed group, W = n x W_local;
    # each rank runs its rows' chunk and the aggregation closes on the mesh
    mesh: Optional[object] = None
    fleet_axis: str = "fleet"
    # device compute path of the masked engine: "block_skip" (the CUDA
    # kernel; needs engine="masked") or "dense" (the only one on "fused")
    compute: str = "dense"
    # kernel block sizes (block_m, block_n, block_k): skip granularity; on
    # the card each must be a multiple of the kernel's 64-wide tile
    compute_blocks: Tuple[int, int, int] = (128, 128, 128)
    cnn: CNNConfig = dataclasses.field(default_factory=default_cnn)
    task: Optional[SyntheticImageTask] = None
    eval_every: int = 1
    seed: int = 0
    device: str = "cuda"


@dataclasses.dataclass
class SimResult:
    method: str
    acc_time: List[Tuple[float, float]]         # (virtual seconds, test acc)
    final_acc: float
    best_acc: float
    best_acc_time: float
    total_time: float
    het_traj: List[Tuple[int, float]]            # (round, H of update times)
    retentions: List[float]                      # final gamma per worker
    param_reduction: float
    flops_reduction: float
    comm_bytes: float
    server_overhead_s: float                     # Alg.2 + aggregation (async: merges) walltime
    recompiles: int                              # distinct training signatures
    similarity_traj: List[Tuple[int, float]]     # Eq. 3 between two workers
    update_times: List[List[float]]              # per round, per worker
    engine: str = "sequential"
    batched_calls: int = 0                       # stacked fleet training calls
    walltime_s: float = 0.0
    host_roundtrips: int = 0                     # extract/embed in the loop
    bucket_sizes: List[int] = dataclasses.field(default_factory=list)
    compute: str = "dense"
    # training-FLOPs ledger, per scheduled plan step x batch images:
    # flops_ideal is the reconfigured sub-model's cost, flops_executed what
    # the dispatch runs (base shapes for dense, kept blocks for block_skip),
    # blocks_executed the executed kernel block cells (host proxy)
    flops_executed: float = 0.0
    flops_ideal: float = 0.0
    blocks_executed: float = 0.0
    images_trained: int = 0                      # ledger images (plan steps x batch)
    train_steps: int = 0                         # trainer steps run, padding included
    flops_per_image_final: float = 0.0
    blocks_per_image_final: float = 0.0
    host_dispatches: int = 0                     # training + evaluation calls
    compile_walltime_s: float = 0.0              # first call of each signature
    prune_events: List[Tuple[int, int, Dict[str, tuple]]] = dataclasses.field(
        default_factory=list
    )
    device: str = "cpu"
    # (round, n_active, n_dropped, n_joined) per round when a scenario ran
    scenario_rounds: List[Tuple[int, int, int, int]] = dataclasses.field(
        default_factory=list
    )
    # fault ledger (core.faults.fault_ledger): all zeros on fault-free runs
    drift_events: int = 0        # drift-multiplier changes (re-learning triggers)
    rounds_degraded: int = 0     # rounds aggregating a fault-reduced cohort
    rounds_skipped: int = 0      # rounds skipped: submitters < min_participants
    workers_recovered: int = 0   # offline -> online transitions
    retry_total: int = 0         # re-join rounds trained without aggregation
    byz_commits: int = 0         # commits from compromised workers
    lost_commits: int = 0        # channel drops surviving every retry
    dup_commits: int = 0         # delivered commits duplicated by the channel
    corrupt_commits: int = 0     # delivered commits with garbled payloads
    # commits the quarantine excluded (sync: quarantined submitter-rounds;
    # async: rejected commits); 0 without SimConfig.robust.quarantine
    quarantined_commits: int = 0
    global_params: Optional[Dict[str, np.ndarray]] = None
    # async on the resident engine: walltime of the one-copy pulls of the
    # trained rows to the host (server_overhead_s holds the merges')
    host_pull_s: float = 0.0
    fused_chunks: int = 0        # device chunks the fused engine ran
    # the mesh the run executed on (SimConfig.mesh): ranks, fleet-axis size
    # and the [W, ...] stacks' spec; 1 / 1 / None without a mesh
    n_devices: int = 1
    fleet_axis_size: int = 1
    shard_spec: Optional[str] = None


def validate_config(sim: SimConfig) -> None:
    """Raise ``ValueError`` naming the first field outside this slice."""
    if sim.method not in SYNC_METHODS + ASYNC_METHODS:
        raise ValueError(f"SimConfig.method: unknown method {sim.method!r}")
    if sim.engine not in ENGINES:
        raise ValueError(f"SimConfig.engine: unknown engine {sim.engine!r}")
    if sim.mesh is not None and (sim.engine != "fused" or sim.method not in SYNC_METHODS):
        raise ValueError(
            "SimConfig.mesh (the mesh-sharded fleet) requires the fused "
            "SYNC engine (engine='fused', method in adaptcl/fedavg/"
            "fedavg_s) — the sharded path is the per-shard lax.scan "
            "chunk program with on-mesh aggregation (core.fused)"
        )
    if sim.engine == "fused":
        validate_fused_config(sim)
    if sim.compute == "block_skip" and sim.engine != "masked":
        raise ValueError(
            "SimConfig.compute='block_skip' needs engine='masked': the "
            "kernel's block-keep flags come from the 0/1 mask stacks, and the "
            "reconfigured engines already run physically small models"
        )
    if sim.regrow is not None and sim.method not in SYNC_METHODS:
        raise ValueError(
            "SimConfig.regrow (FedDST mask readjustment) applies to the "
            "synchronous methods only — async workers never prune, so "
            "there is nothing to regrow"
        )
    if sim.robust is not None and sim.aggregation != "by_worker":
        raise ValueError(
            "SimConfig.robust (clip/trimmed-mean/quarantine) requires "
            "aggregation='by_worker' — the robust layer defends "
            "per-worker commit deltas, and by_unit's per-coordinate "
            f"holder counts have no delta to clip; got "
            f"aggregation={sim.aggregation!r}"
        )
    faults = sim.scenario.faults if sim.scenario is not None else None
    if faults is not None and sim.aggregation != "by_worker":
        for fam in ("byzantine", "channel"):
            if getattr(faults, fam) is not None:
                raise ValueError(
                    f"FaultConfig.{fam} perturbs per-worker commit deltas and "
                    "requires aggregation='by_worker'; got "
                    f"aggregation={sim.aggregation!r}"
                )
    if sim.method in ASYNC_METHODS:
        _validate_async(sim)
    if sim.resident_momentum and sim.engine not in ("masked", "fused"):
        raise ValueError(
            "SimConfig.resident_momentum needs the resident engines "
            "(engine='masked' or 'fused'): the cross-round carry is the fleet "
            "state's momentum stack"
        )
    if sim.scenario is not None and sim.scenario.skew is not None and sim.noniid_s > 0.0:
        raise ValueError(
            "ScenarioConfig.skew (Dirichlet label concentration) and "
            f"SimConfig.noniid_s={sim.noniid_s} are competing Non-IID "
            "partitioners — set exactly one"
        )
    if sim.importance not in METHODS:
        raise ValueError(f"SimConfig.importance: unknown criterion {sim.importance!r}")
    if sim.cnn.kind not in ("vgg", "resnet"):
        raise ValueError(f"SimConfig.cnn: unknown kind {sim.cnn.kind!r}")
    if sim.aggregation not in ("by_worker", "by_unit"):
        raise ValueError(f"SimConfig.aggregation: unknown {sim.aggregation!r}")
    if sim.compute not in ("dense", "block_skip"):
        raise ValueError(f"SimConfig.compute: unknown {sim.compute!r}")


def _validate_async(sim: SimConfig) -> None:
    """The reference's refusals for the async schedulers, in its order and
    with its messages: the sync-only scenario parts and fault families, and
    the trimmed mean."""
    if sim.resident_momentum:
        raise ValueError(
            "resident_momentum is a synchronous-round carry; the async "
            "schedulers restart momentum per commit like their per-worker "
            "twins"
        )
    if sim.scenario is not None:
        _validate_async_scenario(sim.scenario)
    rb = sim.robust
    if rb is not None and rb.any_active and rb.trim > 0.0:
        raise ValueError(
            f"RobustAggConfig.trim={rb.trim} (coordinate-wise trimmed "
            "mean) is a synchronous cohort statistic — async commits arrive "
            "one at a time with no [W, ...] stack to take order statistics "
            "over; async servers support clip + quarantine only"
        )


def _validate_async_scenario(cfg: ScenarioConfig) -> None:
    if cfg.schedule is not None:
        raise ValueError(
            "async schedulers draw their own event stream; per-round "
            "scripted schedules apply to the synchronous methods only"
        )
    if cfg.churn > 0.0:
        raise ValueError(
            "async schedulers reject scenario churn — slot replacement "
            "resets host bookkeeping the event queue does not model; churn "
            "applies to the synchronous methods only"
        )
    f = cfg.faults
    if f is None:
        return
    if f.outage is not None:
        raise ValueError(
            "async schedulers reject the outage fault family — a "
            "coordinated regional blackout is a synchronous-round "
            "concept (outage is sync-only for now); crash/recovery "
            "faults are supported under the async schedulers"
        )
    if f.drift is not None:
        raise ValueError(
            "async schedulers reject the drift fault family — "
            "capability drift exists to trigger prune-rate re-learning "
            "and async workers never prune; drift applies to the "
            "synchronous methods only"
        )
    if f.wave is not None:
        raise ValueError(
            "async schedulers reject the wave fault family — async "
            "client sampling is a static cohort drawn once at run "
            "start, not a per-round C(t); wave applies to the "
            "synchronous methods only"
        )
    if f.byzantine is not None:
        raise ValueError(
            "async schedulers reject the byzantine fault family — the "
            "compromised-cohort draw is a per-round block on the "
            "synchronous fault stream with no per-commit analogue yet "
            "(byzantine is sync-only for now)"
        )
    if f.channel is not None:
        raise ValueError(
            "async schedulers reject the channel fault family — "
            "drop/duplicate/corrupt delivery is modelled at the "
            "synchronous submission boundary, and the pre-simulated "
            "async event plan has no retry clock (channel is sync-only "
            "for now)"
        )


def resolve_device(name: str, what: str = "SimConfig.device") -> torch.device:
    """The run's device (``what`` names the setting in errors).  ``"cuda"``
    without a card raises: nothing falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what}={name!r} but torch sees no CUDA device; "
                "pass device='cpu' to run on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"{what}={name!r}: use 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def ieee_f32():
    """For the duration of a run: TF32 off for matmuls and cuDNN convs, so
    every path computes in IEEE float32, and cuDNN kept to deterministic
    algorithms, so a seed reproduces a dense run exactly (the block_skip
    path is deterministic by construction).  The caller's flags come back
    on exit."""
    flags = [
        (torch.backends.cuda.matmul, "allow_tf32", False),
        (torch.backends.cudnn, "allow_tf32", False),
        (torch.backends.cudnn, "deterministic", True),
    ]
    saved = [getattr(obj, name) for obj, name, _ in flags]
    for obj, name, value in flags:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for (obj, name, _), value in zip(flags, saved):
            setattr(obj, name, value)


class _Env:
    """Shared experimental fixture (same across all methods, per seed)."""

    def __init__(self, sim: SimConfig, base_params=None):
        validate_config(sim)
        self.sim = sim
        self.device = resolve_device(sim.device)
        self.task = sim.task or SyntheticImageTask(
            num_classes=sim.cnn.num_classes, image_size=sim.cnn.image_size,
            train_size=1280, test_size=512, seed=sim.seed,
        )
        skew = sim.scenario.skew if sim.scenario is not None else None
        self.shards = (
            partition_dirichlet(self.task.y_train, sim.num_workers, skew, seed=sim.seed)
            if skew is not None
            else partition_noniid(self.task.y_train, sim.num_workers, sim.noniid_s,
                                  seed=sim.seed)
        )
        if base_params is None:
            gen = torch.Generator().manual_seed(sim.seed)
            self.base_params = init_cnn(sim.cnn, gen, self.device)
        else:
            self.base_params = params_from_numpy(
                {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
                 for k, v in base_params.items()},
                self.device,
            )
        self.base_shapes = {k: tuple(v.shape) for k, v in self.base_params.items()}
        self.space, self.unit_map = build_unit_space(sim.cnn, self.base_params)
        self.full_bytes = payload_bytes(full_index(self.space), self.space)
        self.full_flops = cnn_flops(self.base_params, sim.cnn)
        self.bandwidths = make_bandwidths(sim.het, self.full_bytes, sim.t_train_full)
        self.trainer = LocalTrainer(
            sim.cnn, lr=sim.lr, compute=sim.compute,
            compute_blocks=sim.compute_blocks, device=self.device,
        )
        self.fleet = FleetEngine(
            self.trainer, self.unit_map, self.base_shapes, self.device, engine=sim.engine
        )
        self.rng = np.random.default_rng(sim.seed + 17)
        self.x_test = torch.as_tensor(self.task.x_test, device=self.device)
        self.flops_executed = 0.0
        self.flops_ideal = 0.0
        self.blocks_executed = 0.0
        self.images_trained = 0
        self._acct_cache: Dict[tuple, Tuple[float, float, float]] = {}

    def cost_for_index(self, index) -> Tuple[float, float, float]:
        """(executed flops, ideal flops, executed kernel blocks) per IMAGE at
        this global index, for this run's compute path."""
        key = tuple((l, tuple(map(int, v))) for l, v in sorted(index.items()))
        cached = self._acct_cache.get(key)
        if cached is None:
            shapes = subparam_shapes(index, self.unit_map, self.base_shapes)
            ideal = cnn_flops_from_shapes(shapes, self.sim.cnn)
            if self.sim.compute == "block_skip":
                masks = {
                    l.name: np.asarray(
                        np.isin(np.arange(l.num_units), index[l.name]), np.float32
                    )
                    for l in self.space.layers
                }
                bc = cnn_block_compute(self.sim.cnn, masks, self.sim.compute_blocks)
                cached = (bc["flops"], ideal, bc["blocks"])
            elif self.sim.engine in ("masked", "fused"):
                # dense masked programs run the base shapes regardless of masks
                cached = (self.full_flops, ideal, 0.0)
            else:
                # physically reconfigured models execute exactly their size
                cached = (ideal, ideal, 0.0)
            self._acct_cache[key] = cached
        return cached

    def account_train(self, index, steps: int):
        """Record one worker's local-training phase in the FLOPs ledger."""
        if steps <= 0:
            return
        executed, ideal, blocks = self.cost_for_index(index)
        images = steps * self.sim.batch_size
        self.flops_executed += images * executed
        self.flops_ideal += images * ideal
        self.blocks_executed += images * blocks
        self.images_trained += images

    def phi(self, worker: int, shapes: Mapping[str, tuple], jitter: bool,
            payload_factor: float = 1.0, time_mult: float = 1.0) -> float:
        """Eq. 6/7 channel-model update time of a sub-model of these
        (reconfigured) shapes; ``jitter`` draws one multiplicative factor
        from ``env.rng``, in the reference's order.  ``payload_factor``
        scales the payload (DGC); ``time_mult`` (capability drift) joins the
        jitter in one factor, ``t * (jitter * time_mult)``, the reference's
        float grouping."""
        sim = self.sim
        jmult = (
            float(np.exp(self.rng.normal(0, sim.time_jitter)))
            if jitter and sim.time_jitter > 0 else 1.0
        )
        return self.phi_from_cost(
            worker, sum(int(np.prod(s)) * 4 for s in shapes.values()),
            cnn_flops_from_shapes(shapes, sim.cnn), payload_factor, jmult * time_mult,
        )

    def phi_from_cost(self, worker: int, bytes_raw: int, flops_w: float,
                      payload_factor: float = 1.0, jitter_mult: float = 1.0) -> float:
        """The channel model from payload bytes and FLOPs: the one
        implementation behind ``phi`` and the fused engine's cached costs
        (jitter pre-drawn), so their clocks agree to the bit."""
        sim = self.sim
        bytes_w = payload_factor * bytes_raw
        rel = flops_w / self.full_flops
        t_train = sim.t_train_full * ((1 - sim.train_sens) + sim.train_sens * rel)
        t = 2.0 * bytes_w / self.bandwidths[worker] + t_train * sim.local_epochs
        return t * jitter_mult

    def phi_from_index(self, worker: int, index, payload_factor: float = 1.0,
                       jitter: bool = True, time_mult: float = 1.0) -> float:
        """``phi`` of the sub-model at this global index (shapes from
        ``subparam_shapes``, nothing materialized); draws its jitter from
        ``env.rng`` as the reference's does."""
        return self.phi(worker, subparam_shapes(index, self.unit_map, self.base_shapes),
                        jitter, payload_factor=payload_factor, time_mult=time_mult)

    def shard_xy(self, w):
        sh = self.shards[w]
        return self.task.x_train[sh], self.task.y_train[sh]


def _env_accuracy(env: _Env, params) -> float:
    """Test accuracy of the global model: dense ``F.conv2d`` in batches of
    256, each batch one counted dispatch (``count_compile=False``)."""
    cfg = env.sim.cnn
    y = env.task.y_test
    correct = 0

    def logits_of(p, xb):
        with torch.no_grad():
            return cnn_apply(p, cfg, xb).argmax(-1).cpu().numpy()

    for i in range(0, len(y), 256):
        xb = env.x_test[i : i + 256]
        pred = env.trainer.dispatch(
            ("eval_logits", tuple(xb.shape)), logits_of, params, xb, count_compile=False
        )
        correct += int((pred == y[i : i + 256]).sum())
    return correct / len(y)


# ---------------------------------------------------------------------------
# synchronous methods: fedavg / fedavg_s / adaptcl
# ---------------------------------------------------------------------------

def _dgc_compress(delta: Dict[str, np.ndarray], residual: Dict[str, np.ndarray],
                  sparsity: float):
    """Top-|.| delta sparsification with local residual accumulation ([11]).

    Returns (committed delta, new residual, kept-fraction payload factor).

    A reconfiguration that changed a tensor's shape restarts DGC's
    accumulators for it (momentum-factor-masking semantics): the stale
    residual is dropped AND the tensor commits densely this round, so the
    kept-fraction accounting is reset too — the payload factor honestly
    reflects the dense warm-up commit instead of silently reporting the
    steady-state sparsity."""
    committed, new_res = {}, {}
    kept = total = 0
    for k, d in delta.items():
        r = residual.get(k)
        restarted = r is not None and r.shape != d.shape
        if r is not None and not restarted:
            d = d + r
        if restarted:
            committed[k], new_res[k] = d, np.zeros_like(d)
            kept += d.size
            total += d.size
            continue
        flat = np.abs(d).ravel()
        # keep budget in float32 — the SAME rounding the reference's device
        # compressor (aggregation.dgc_compress_jnp) performs, so keep sets
        # can't diverge on half-integer budgets
        n_keep = max(
            1, int(np.round(np.float32(flat.size) * np.float32(1.0 - sparsity)))
        )
        if n_keep >= flat.size:
            committed[k], new_res[k] = d, np.zeros_like(d)
            kept += flat.size
        else:
            thr = np.partition(flat, flat.size - n_keep)[flat.size - n_keep]
            mask = np.abs(d) >= thr
            committed[k] = d * mask
            new_res[k] = d * (1.0 - mask)
            # ties at the threshold all commit (>=), so count the REALIZED
            # mask — n_keep undercounts exactly when |delta| values collide
            kept += int(mask.sum())
        total += flat.size
    # payload: kept values + their indices (~1.25x values, as in DGC)
    return committed, new_res, 1.25 * kept / max(total, 1)


def _dgc_compress_stacked(
    delta: Dict[str, np.ndarray],        # {path: [W, ...]} base-coord deltas
    residual: Dict[str, np.ndarray],     # {path: [W, ...]} accumulators
    sparsity: float,
    masks: Optional[Dict[str, np.ndarray]] = None,   # {path: [W, ...]} 0/1
    rows: Optional[np.ndarray] = None,               # bool [W]: rows to commit
):
    """Vectorized DGC over the resident ``[W, ...]`` delta stacks.

    Per tensor, the top-|.| threshold is computed per worker row in one
    ``np.sort`` over the flattened ``[W, N]`` view.  ``masks`` makes the
    compressor mask-aware: each worker's keep budget is a fraction of its
    RETAINED coordinate count (matching the per-worker compressor applied to
    the reconfigured tensor), pruned coordinates are never committed, and the
    residual is kept only on retained coordinates (pruning zeroes a worker's
    residual on the units it lost — nothing else restarts, unlike the
    shape-changing per-worker path, because resident shapes never change).
    ``rows`` limits commits to the submitting workers; others keep their
    residual untouched and report payload factor 1.0.

    Returns (committed stacks, new residual stacks, factors ``[W]``)."""
    W = next(iter(delta.values())).shape[0]
    rows = np.ones(W, bool) if rows is None else np.asarray(rows, bool)
    committed: Dict[str, np.ndarray] = {}
    new_res: Dict[str, np.ndarray] = {}
    kept = np.zeros(W)
    total = np.zeros(W)
    for k, d in delta.items():
        r = residual.get(k)
        acc = d if r is None else d + r
        flat = acc.reshape(W, -1)
        absf = np.abs(flat)
        if masks is not None:
            valid = masks[k].reshape(W, -1) > 0
            sizes = valid.sum(axis=1)
            absf = np.where(valid, absf, -1.0)
        else:
            valid = None
            sizes = np.full(W, flat.shape[1])
        # float32 keep budgets, matching the reference's device compressor
        # (aggregation.dgc_compress_jnp) exactly
        n_keep = np.maximum(
            1,
            np.round(
                sizes.astype(np.float32) * np.float32(1.0 - sparsity)
            ).astype(np.int64),
        )
        n_keep = np.minimum(n_keep, np.maximum(sizes, 1))
        order = np.sort(absf, axis=1)[:, ::-1]
        thr = order[np.arange(W), n_keep - 1]
        keep = absf >= thr[:, None]
        if valid is not None:
            keep &= valid
        com = np.where(keep, flat, 0.0)
        res = np.where(keep, 0.0, flat)
        if valid is not None:
            res = np.where(valid, res, 0.0)
        old_res = np.zeros_like(flat) if r is None else r.reshape(W, -1)
        rowsf = rows[:, None]
        committed[k] = np.where(rowsf, com, 0.0).reshape(d.shape).astype(d.dtype)
        new_res[k] = np.where(rowsf, res, old_res).reshape(d.shape).astype(d.dtype)
        # realized per-row commit counts: ties at the threshold all pass the
        # >= test, and a fully-masked row (sizes == 0) commits nothing — the
        # keep mask already reflects both, n_keep reflects neither
        kept += np.where(rows, keep.sum(axis=1), 0)
        total += np.where(rows, sizes, 0)
    factors = np.where(rows, 1.25 * kept / np.maximum(total, 1), 1.0)
    return committed, new_res, factors


def _regrow_alpha(cfg: RegrowConfig, t: int, rounds: int) -> float:
    """Readjust fraction in force at the start of round t (FedDST anneal)."""
    if cfg.schedule == "constant":
        return cfg.alpha0
    return float(0.5 * cfg.alpha0 * (1.0 + np.cos(np.pi * (t - 1) / max(rounds, 1))))


def _regrow_round(sim: SimConfig, t: int) -> bool:
    """Does a readjustment fire at the START of round t?  Every
    ``interval`` completed rounds: the first is round ``interval + 1``."""
    return sim.regrow is not None and t > 1 and (t - 1) % sim.regrow.interval == 0


def _weight_magnitude_scores(params, unit_map, unit_counts) -> Dict[str, np.ndarray]:
    """Per-unit L2 group norms of a base-coordinate host param dict, float64:
    the shrink order of a readjustment, one per regrow round for every
    worker."""
    acc = {k: np.zeros(n, np.float64) for k, n in unit_counts.items()}
    for path, entries in unit_map.items():
        arr = params.get(path)
        if arr is None:
            continue
        sq = np.asarray(arr, np.float64) ** 2
        for lname, axis in entries:
            if lname not in acc:
                continue
            axes = tuple(i for i in range(sq.ndim) if i != axis)
            acc[lname] += sq.sum(axis=axes)
    return {k: np.sqrt(v) for k, v in acc.items()}


def _regrow_step(sim: SimConfig, env: _Env, global_params, indices, t: int
                 ) -> List[Tuple[int, Dict[str, np.ndarray]]]:
    """One FedDST readjustment at the start of round t.

    Per worker with retention < 1: ``prune_to_budget`` removes ``alpha_t``
    of its retained mass by the global's weight magnitude, then
    ``regrow_index`` adds the same integer parameter budget back, ranked by
    |grad| of the dense model at the global on the worker's first 64
    images (``trainer.gradient``, one call a readjusted worker).  Draws
    nothing from ``env.rng``, so a run without regrowth is unchanged.
    Rewrites ``indices`` in place; returns ``[(worker, new_index)]``."""
    alpha_t = _regrow_alpha(sim.regrow, t, sim.rounds)
    if alpha_t <= 0.0:
        return []
    shrink_scores = None
    out: List[Tuple[int, Dict[str, np.ndarray]]] = []
    for w in range(sim.num_workers):
        if retention(indices[w], env.space) >= 1.0:
            continue   # full model: no absent units to grow back
        if shrink_scores is None:
            shrink_scores = _weight_magnitude_scores(
                params_to_numpy(global_params), env.unit_map, env.space.unit_counts
            )
        shrunk = prune_to_budget(indices[w], shrink_scores, alpha_t, env.space)
        budget = sum(
            (len(indices[w][l.name]) - len(shrunk[l.name])) * l.unit_param_cost
            for l in env.space.layers
        )
        if budget <= 0:
            continue
        x, y = env.shard_xy(w)
        grads = env.trainer.gradient(global_params, env.unit_map, x[:64], y[:64])
        grow_scores = grad_magnitude_scores(
            params_to_numpy(grads), env.unit_map, env.space.unit_counts
        )
        indices[w] = regrow_index(shrunk, grow_scores, budget, env.space)
        out.append((w, indices[w]))
    return out


def _skip_round_time(env: _Env, scen: ScenarioEngine, indices, round_t: int) -> float:
    """Clock advance of a SKIPPED round (too few fault survivors): the
    server waits out the straggler deadline, ``timeout_factor`` x the slowest
    nominal update time at the current sub-models.  Jitter-free and
    RNG-free."""
    mults = scen.drift_mults(round_t)
    phis = [env.phi_from_index(w, indices[w], jitter=False, time_mult=float(mults[w]))
            for w in range(len(indices))]
    return scen.cfg.timeout_factor * max(phis)


def _to_device(arrays: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host params as float32 tensors (a clipped async commit leaves the
    server's params in float64; the reference's arrays enter JAX as float32)."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()}


def _commit_multiplicity(events) -> np.ndarray:
    """Per-worker commit weight: submit x delivered x (1 + dup), host
    float64.  With no channel model it is the submitter indicator, so its
    normalized weights are the plain mean's."""
    mult = events.submitters.astype(np.float64)
    if events.delivered is not None:
        mult = mult * events.delivered * (1.0 + events.dup)
    return mult


def _robust_statics(sim: SimConfig):
    """``(byzantine cfg, channel cfg, corruption on, active robust cfg,
    robust path on)``: all None/False leaves every branch the plain one."""
    faults = sim.scenario.faults if sim.scenario is not None else None
    byz_cfg = faults.byzantine if faults is not None else None
    ch_cfg = faults.channel if faults is not None else None
    corrupt_on = ch_cfg is not None and ch_cfg.corrupt > 0.0
    rb_cfg = sim.robust if sim.robust is not None and sim.robust.any_active else None
    robust_on = byz_cfg is not None or ch_cfg is not None or rb_cfg is not None
    return byz_cfg, ch_cfg, corrupt_on, rb_cfg, robust_on


def _robust_step_kwargs(byz_cfg, ch_cfg, corrupt_on, rb_cfg) -> dict:
    """The static keyword arguments of ``robust_submission_step_dev`` for
    this world (the reference's defaults where a family is off)."""
    return dict(
        byz_mode=byz_cfg.mode if byz_cfg is not None else "sign_flip",
        byz_scale=byz_cfg.scale if byz_cfg is not None else -10.0,
        byz_noise_std=byz_cfg.noise_std if byz_cfg is not None else 1.0,
        corrupt_std=ch_cfg.corrupt_std if corrupt_on else 10.0,
        clip=rb_cfg.clip if rb_cfg is not None else None,
        trim=rb_cfg.trim if rb_cfg is not None else 0.0,
        quarantine=rb_cfg.quarantine if rb_cfg is not None else None,
    )


def _robust_aggregate(stacks, masks, global_params, mult, events, byz_cfg, ch_cfg,
                      corrupt_on, rb_cfg, seed: int, t: int, strikes, quar_left):
    """The reference's ``_robust_aggregate_host``: one robust server round
    on ``[W, ...]`` stacks (device tensors) through
    ``robust_submission_step_dev``, the function the fused chunk runs.
    Returns ``(new global, strikes', quar_left', quar_now)``, ``quar_now`` a
    host bool ``[W]`` or None."""
    dev = next(iter(stacks.values())).device
    ms = mult.sum()
    weights = (mult / ms).astype(np.float32) if ms > 0 else np.zeros_like(mult, np.float32)
    byz_row = (events.byz & events.submitters
               if byz_cfg is not None and events.byz is not None else None)
    cor_row = (events.corrupt & events.delivered & events.submitters
               if corrupt_on and events.corrupt is not None else None)
    new_g, st2, qu2, quar_now = robust_submission_step_dev(
        stacks, masks, global_params,
        torch.as_tensor(mult.astype(np.float32), device=dev),
        torch.as_tensor(weights, device=dev), byz_row, cor_row,
        noise_key(seed + 51721, t) if byz_cfg is not None else None,
        noise_key(seed + 51722, t) if corrupt_on else None,
        strikes, quar_left, **_robust_step_kwargs(byz_cfg, ch_cfg, corrupt_on, rb_cfg),
    )
    return new_g, st2, qu2, None if quar_now is None else quar_now.cpu().numpy()


def _run_sync(sim: SimConfig, env: _Env) -> SimResult:
    W = sim.num_workers
    sparse = sim.method in ("fedavg_s", "adaptcl")
    adapt = sim.method == "adaptcl"
    lam = sim.lam if sparse else 0.0
    resident = sim.engine == "masked"
    scen = ScenarioEngine(sim.scenario, W) if sim.scenario is not None else None
    byz_cfg, ch_cfg, corrupt_on, rb_cfg, robust_on = _robust_statics(sim)
    rb_strikes = rb_quar = None
    if rb_cfg is not None and rb_cfg.quarantine is not None:
        rb_strikes = torch.zeros(W, dtype=torch.int32, device=env.device)
        rb_quar = torch.zeros(W, dtype=torch.int32, device=env.device)
    quarantined_commits = 0
    dgc_residuals: List[Dict[str, np.ndarray]] = [{} for _ in range(W)]
    dgc_res_stack: Optional[Dict[str, np.ndarray]] = None

    global_params = dict(env.base_params)
    indices = [full_index(env.space) for _ in range(W)]
    histories = [WorkerHistory() for _ in range(W)]
    pending_rates = [0.0] * W
    cig_scores = None              # frozen at first pruning (CIG principle)
    interval_phis: List[List[float]] = [[] for _ in range(W)]
    prune_round_count = 0
    prune_events: List[Tuple[int, int, Dict[str, tuple]]] = []

    state = None
    pad_a = pad_b = None
    if resident:
        shard_x, shard_y = zip(*(env.shard_xy(w) for w in range(W)))
        state = env.fleet.init_state(env.base_params, list(shard_x), list(shard_y))
        if sim.resident_momentum:
            env.fleet.init_momentum(state)
        # constant per-phase step pads (churn keeps shard sizes fixed): every
        # sub-stack shares one plan shape per phase
        pad_a = max(
            plan_steps(len(env.shards[w]), sim.batch_size, sim.local_epochs) for w in range(W)
        )
        pad_b = max(
            plan_steps(len(env.shards[w]), sim.batch_size, (1 - sim.beta) * sim.local_epochs)
            for w in range(W)
        )
        if sim.dgc_sparsity > 0.0:
            dgc_res_stack = {
                k: np.zeros((W,) + tuple(s), np.float32) for k, s in env.base_shapes.items()
            }

    clock = 0.0
    comm_bytes = 0.0
    server_overhead = 0.0
    acc_time, het_traj, sim_traj, upd_times = [], [], [], []
    scen_rows: List[Tuple[int, int, int, int]] = []
    events_log: List = []
    acc_time.append((0.0, _env_accuracy(env, global_params)))
    rt_base = roundtrip_total()

    def _learn_rates(t: int, drift_trigger: bool):
        """One Alg. 2 server step (a pruning-interval boundary or a drift
        event).  A drift event first invalidates the drifted worker's
        (gamma, phi) history: it re-enters through the bootstrap path."""
        nonlocal prune_round_count, cig_scores, pending_rates, interval_phis
        prune_round_count += 1
        if cig_scores is None and sim.importance == "cig_bnscalor":
            cig_scores = METHODS["cig_bnscalor"](ImportanceContext(
                unit_counts=env.space.unit_counts,
                scales=extract_bn_scales(global_params, sim.cnn),
            ))
        if drift_trigger:
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
            rates = (
                sim.fixed_pruned_rates[k] if k < len(sim.fixed_pruned_rates) else [0.0] * W
            )
        else:
            rates = learn_pruned_rates(histories, gammas_now, phis_now, sim.rate_cfg)
        pending_rates = list(rates)
        interval_phis = [[] for _ in range(W)]

    def _scores_for(worker: int, params_w):
        """Scores in base coordinates for this worker's pruning event.  The
        data-dependent criteria read the worker's trained sub-model: on the
        resident engine its stack row, extracted here (one round trip)."""
        if sim.importance == "cig_bnscalor":
            if cig_scores is None:
                raise RuntimeError("CIG order not yet frozen")
            return cig_scores
        ctx_kw = dict(unit_counts=env.space.unit_counts, worker=worker,
                      round=prune_round_count, seed=sim.seed)
        if sim.importance in DATA_DEPENDENT:
            if params_w is None:
                row = {k: v[worker] for k, v in state.params.items()}
                params_w = extract_subparams(row, indices[worker], env.unit_map)
            x, y = env.shard_xy(worker)
            stats = local_unit_stats(
                env.trainer, params_w, indices[worker], env.space, env.unit_map, x, y
            )
            ctx_kw.update(weight_norms=stats["weight_norms"], grads=stats["grads"],
                          activations=stats["activations"])
        return METHODS[sim.importance](ImportanceContext(**ctx_kw))

    def _restart_residuals(w: int):
        dgc_residuals[w] = {}
        if dgc_res_stack is not None:
            for k in dgc_res_stack:
                dgc_res_stack[k][w] = 0.0

    for t in range(1, sim.rounds + 1):
        events = scen.draw(t) if scen is not None else full_participation(W)
        events_log.append(events)
        # churn: a replaced slot restarts as a fresh full-model worker on a
        # fresh shard (one fresh_shard draw per joined slot, ascending)
        if events.joined.any():
            joined = [int(w) for w in np.flatnonzero(events.joined)]
            for w in joined:
                indices[w] = full_index(env.space)
                histories[w] = WorkerHistory()
                pending_rates[w] = 0.0
                interval_phis[w] = []
                _restart_residuals(w)
                env.shards[w] = scen.fresh_shard(len(env.shards[w]), len(env.task.y_train))
                if resident:
                    env.fleet.update_shard(state, w, *env.shard_xy(w))
            if resident:
                env.fleet.zero_momentum_rows(state, joined)
                env.fleet.refresh_masks(state, indices)
        # crash recovery: a returning worker refetches the global (the
        # ordinary broadcast-back) with its last mask and history, but its
        # momentum and DGC residual restart
        if events.recovered is not None and events.recovered.any():
            recovered = [int(w) for w in np.flatnonzero(events.recovered)]
            for w in recovered:
                _restart_residuals(w)
            if resident:
                env.fleet.zero_momentum_rows(state, recovered)
        active_ws = [int(w) for w in np.flatnonzero(events.active)]
        if scen is not None:
            scen_rows.append(
                (t, len(active_ws), int(events.dropped.sum()), int(events.joined.sum()))
            )

        # FedDST readjustment at the round start, before broadcast-back, so
        # grown units take the global's values (resident: a mask rewrite)
        if _regrow_round(sim, t):
            regrown = _regrow_step(sim, env, global_params, indices, t)
            for w, idx_w in regrown:
                prune_events.append((t, int(w), {k: tuple(map(int, v)) for k, v in idx_w.items()}))
            if resident and regrown:
                env.fleet.refresh_masks(state, indices)

        # too few fault survivors: nothing trains, the global is untouched,
        # the clock waits out the deadline; Alg. 2 and evals still run
        if events.skip:
            clock += _skip_round_time(env, scen, indices, t)
            upd_times.append([float("nan")] * W)
            t0 = _time.perf_counter()
            if adapt and (t % sim.prune_interval == 0 or events.drift_changed):
                _learn_rates(t, events.drift_changed)
            server_overhead += _time.perf_counter() - t0
            if t % sim.eval_every == 0:
                acc_time.append((clock, _env_accuracy(env, global_params)))
            continue

        # batch plans of the active workers, drawn in worker order up front
        # (the reference's order)
        plans_a: List[Optional[np.ndarray]] = [None] * W
        plans_b: List[Optional[np.ndarray]] = [None] * W
        prune_now = [False] * W
        for w in active_ws:
            rate = pending_rates[w] if adapt else 0.0
            if adapt and rate > 0.0:
                e1, e2 = sim.beta * sim.local_epochs, (1 - sim.beta) * sim.local_epochs
                prune_now[w] = True
            else:
                e1, e2 = sim.local_epochs, 0.0
            n = len(env.shards[w])
            plans_a[w] = make_batch_plan(n, sim.batch_size, e1, env.rng)
            plans_b[w] = make_batch_plan(n, sim.batch_size, e2, env.rng)
        for w in active_ws:   # FLOPs ledger: phase A runs at the pre-prune index
            env.account_train(indices[w], plans_a[w].shape[0])

        # phase A.  Resident: broadcast-back as a masked scatter, one fleet
        # call (a row bucket when only part of the fleet is active).
        # Reconfiguring: each worker's sub-model extracted from the global
        # model, the jobs trained by the engine.
        worker_params: Dict[int, Dict[str, torch.Tensor]] = {}
        if resident:
            env.fleet.scatter_global(state, global_params)
            env.fleet.train_rounds(state, plans_a, lam, pad_steps=pad_a,
                                   carry_momentum=sim.resident_momentum)
        else:
            jobs_a = []
            for w in active_ws:
                x, y = env.shard_xy(w)
                jobs_a.append(FleetJob(
                    worker=w, params=extract_subparams(global_params, indices[w], env.unit_map),
                    index=indices[w], x=x, y=y, plan=plans_a[w],
                ))
            for w, p in zip(active_ws, env.fleet.train_all(jobs_a, lam)):
                worker_params[w] = p

        # phase B: pruning workers prune at position beta (resident: a mask
        # row rewrite; reconfiguring: slice the sub-model), then finish
        jobs_b: List[FleetJob] = []
        pruned_any = False
        for w in active_ws:
            if not prune_now[w]:
                continue
            scores = _scores_for(w, worker_params.get(w))
            if resident:
                indices[w] = prune_to_budget(indices[w], scores, pending_rates[w], env.space)
                pruned_any = True
            else:
                worker_params[w], indices[w] = env.trainer.prune_and_reconfigure(
                    worker_params[w], indices[w], scores, pending_rates[w],
                    env.space, env.unit_map,
                )
                if plans_b[w].shape[0] > 0:
                    x, y = env.shard_xy(w)
                    jobs_b.append(FleetJob(worker=w, params=worker_params[w], index=indices[w],
                                           x=x, y=y, plan=plans_b[w]))
            prune_events.append((t, int(w), {k: tuple(map(int, v)) for k, v in indices[w].items()}))
        if resident and pruned_any:
            env.fleet.refresh_masks(state, indices)
            env.fleet.train_rounds(
                state, [plans_b[w] if prune_now[w] else None for w in range(W)],
                lam, pad_steps=pad_b, carry_momentum=sim.resident_momentum,
            )
        elif jobs_b:
            for job, trained in zip(jobs_b, env.fleet.train_all(jobs_b, lam)):
                worker_params[job.worker] = trained
        for w in active_ws:   # FLOPs ledger: phase B runs at the pruned index
            if prune_now[w]:
                env.account_train(indices[w], plans_b[w].shape[0])

        # submission boundary: DGC (host numpy, as in the reference), then
        # the channel model
        submitters = events.submitters
        payload = np.ones(W)
        agg_stacks = state.params if resident else None
        if sim.dgc_sparsity > 0.0 and resident:
            P = env.fleet.params_host(state)
            M = env.fleet.masks_host(state)
            g = {k: v.cpu().numpy() for k, v in global_params.items()}
            deltas = {k: P[k] - g[k][None] * M[k] for k in P}
            committed, dgc_res_stack, payload = _dgc_compress_stacked(
                deltas, dgc_res_stack, sim.dgc_sparsity, masks=M, rows=submitters,
            )
            agg_stacks = _to_device({k: g[k][None] * M[k] + committed[k] for k in P}, env.device)
        elif sim.dgc_sparsity > 0.0:
            for w in active_ws:
                if not submitters[w]:
                    continue
                received = {k: v.cpu().numpy() for k, v in
                            extract_subparams(global_params, indices[w], env.unit_map).items()}
                delta = {k: worker_params[w][k].cpu().numpy() - received[k]
                         for k in worker_params[w]}
                committed_w, dgc_residuals[w], payload[w] = _dgc_compress(
                    delta, dgc_residuals[w], sim.dgc_sparsity
                )
                worker_params[w] = _to_device(
                    {k: received[k] + committed_w[k] for k in delta}, env.device
                )

        phis = np.full(W, np.nan)
        dm = events.drift_mult
        for w in active_ws:
            pf = float(payload[w]) if submitters[w] else 1.0
            if resident:
                shapes_w = subparam_shapes(indices[w], env.unit_map, env.base_shapes)
            else:
                shapes_w = {k: tuple(v.shape) for k, v in worker_params[w].items()}
            # channel retries stretch the drift factor first (d * r), then
            # the jitter joins: the fused engine's float grouping
            retry_mult = 1.0
            if ch_cfg is not None and events.retries is not None and submitters[w]:
                retry_mult = 1.0 + ch_cfg.retry_backoff * float(events.retries[w])
            phi_w = env.phi(w, shapes_w, jitter=True, payload_factor=pf,
                            time_mult=(float(dm[w]) if dm is not None else 1.0) * retry_mult)
            phis[w] = phi_w
            interval_phis[w].append(phi_w)
            if submitters[w]:
                bytes_w = sum(int(np.prod(s)) * 4 for s in shapes_w.values())
                # every retry re-sends the upload; a delivered duplicate
                # arrives twice
                extra = 0.0
                if ch_cfg is not None and events.retries is not None:
                    extra = (float(events.retries[w])
                             + float(events.dup[w] & events.delivered[w])) * pf * bytes_w
                comm_bytes += 2.0 * pf * bytes_w + extra
            pending_rates[w] = 0.0
        sub_phis = phis[submitters]
        round_time = float(sub_phis.max())
        if events.dropped.any() and scen is not None:
            round_time *= scen.cfg.timeout_factor   # the server waits out the deadline
        clock += round_time                     # BSP: the slowest received gates
        upd_times.append(list(phis))
        het_traj.append((t, heterogeneity_from_times(sub_phis)))
        if W > 3:
            sim_traj.append((t, similarity(indices[1], indices[3])))

        t0 = _time.perf_counter()
        quar_now = None
        if resident and sim.aggregation == "by_unit":
            agg = aggregate_by_unit_stacked(agg_stacks, state.masks, submitters)
        elif resident and robust_on:
            mult = _commit_multiplicity(events)
            agg, rb_strikes, rb_quar, quar_now = _robust_aggregate(
                agg_stacks, state.masks, global_params, mult, events, byz_cfg, ch_cfg,
                corrupt_on, rb_cfg, sim.seed, t, rb_strikes, rb_quar)
        elif resident:
            agg = aggregate_by_worker_stacked(agg_stacks, submitters / submitters.sum())
        elif robust_on and sim.aggregation != "by_unit":
            # the per-worker engines embed their submissions into [W, ...]
            # base stacks for the same robust round; rows without a commit
            # carry their masked global (a zero delta), weight 0
            mult = _commit_multiplicity(events)
            masks_np = {k: np.stack([coordinate_mask(k, indices[w], env.unit_map, env.base_shapes)
                                     for w in range(W)]).astype(np.float32)
                        for k in env.base_shapes}
            stack_masks = _to_device(masks_np, env.device)
            rows = []
            for w in range(W):
                if w in worker_params:
                    rows.append(embed_params(worker_params[w], indices[w], env.unit_map,
                                             env.base_shapes))
                else:
                    rows.append({k: global_params[k] * stack_masks[k][w] for k in stack_masks})
            stacks = {k: torch.stack([r[k].float() for r in rows]) for k in stack_masks}
            agg, rb_strikes, rb_quar, quar_now = _robust_aggregate(
                stacks, stack_masks, global_params, mult, events, byz_cfg, ch_cfg,
                corrupt_on, rb_cfg, sim.seed, t, rb_strikes, rb_quar)
        else:
            submissions = [(worker_params[w], indices[w]) for w in active_ws if submitters[w]]
            aggregate = aggregate_by_unit if sim.aggregation == "by_unit" else aggregate_by_worker
            agg = aggregate(submissions, env.unit_map, env.base_shapes)
        if quar_now is not None:
            quarantined_commits += int((quar_now & (mult > 0)).sum())
        global_params = {k: v.float() for k, v in agg.items()}
        if adapt and (t % sim.prune_interval == 0 or events.drift_changed):
            _learn_rates(t, events.drift_changed)
        server_overhead += _time.perf_counter() - t0

        if t % sim.eval_every == 0:
            acc_time.append((clock, _env_accuracy(env, global_params)))

    host_roundtrips = roundtrip_total() - rt_base
    final_costs = [env.cost_for_index(indices[w]) for w in range(W)]
    return _finalize(
        sim, env, acc_time, het_traj, sim_traj, upd_times,
        [retention(indices[w], env.space) for w in range(W)],
        [extract_subparams(global_params, indices[w], env.unit_map) for w in range(W)],
        comm_bytes, server_overhead, clock,
        global_params=global_params, host_roundtrips=host_roundtrips,
        flops_per_image_final=float(np.mean([c[0] for c in final_costs])),
        blocks_per_image_final=float(np.mean([c[2] for c in final_costs])),
        prune_events=prune_events, scenario_rounds=scen_rows,
        fault_ledger={**fault_ledger(events_log), "quarantined_commits": quarantined_commits},
    )


# ---------------------------------------------------------------------------
# asynchronous methods: fedasync_s / ssp_s / dcasgd_s
# ---------------------------------------------------------------------------

def _plan_async_events(sim: SimConfig, env: _Env, scen: Optional[ScenarioEngine],
                       participants: np.ndarray) -> AsyncEventPlan:
    """Pre-simulate the whole async discrete-event run (no training).

    The reference's RNG and heap order: the initial ``schedule`` per
    participant ascending (one jitter draw each), then per window batch: the
    heap pops (``(time, worker)`` tuples, so equal finish times pop the lower
    worker first), one ``make_batch_plan`` per popped row in pop order, one
    ``scen.rng`` dropout draw per popped row (only when dropout > 0), one
    ``fault_rng`` crash draw per popped row (only when crash is on), then
    the per-commit walk: clock running max, staleness before the version
    bump, the SSP block/unblock walk with its reschedule jitter draws, eval
    flags.

    A dropped (timed-out) commit trains, counts toward ``rounds_done`` and
    refetches, but is never merged: no version bump, no bytes.  A crashed
    worker's commit lands; its next schedule waits ``outage_rounds``
    jitter-free update times."""
    W = sim.num_workers
    method = sim.method
    idx = full_index(env.space)
    n_part = len(participants)
    drop_p = scen.cfg.dropout if scen is not None else 0.0
    crash = scen.cfg.faults.crash if scen is not None and scen.cfg.faults is not None else None
    n_crashes = 0

    fetched_ver = np.zeros(W, np.int64)
    rounds_done = np.zeros(W, np.int64)
    last_push = np.zeros(W, np.int64)
    version = 0
    push_counter = 0
    total_commits = n_part * sim.rounds
    commits = 0
    clock = 0.0
    heap: List[Tuple[float, int]] = []

    def schedule(w, now):
        nonlocal push_counter
        heapq.heappush(heap, (now + env.phi_from_index(w, idx), w))
        last_push[w] = push_counter
        push_counter += 1

    for w in participants:
        schedule(int(w), 0.0)

    workers, finishes, push_seq, staleness, versions = [], [], [], [], []
    dropped, refetch, evals, clocks, plans = [], [], [], [], []
    batch_starts = [0]
    blocked: List[int] = []
    window = sim.async_window
    while commits < total_commits and heap:
        batch = [heapq.heappop(heap)]
        while (window > 0.0 and heap and len(batch) < total_commits - commits
               and heap[0][0] <= batch[0][0] + window):
            batch.append(heapq.heappop(heap))
        batch_plans = [
            make_batch_plan(len(env.shards[w]), sim.batch_size, sim.local_epochs, env.rng)
            for _, w in batch
        ]
        drops = ([bool(scen.rng.random() < drop_p) for _ in batch]
                 if drop_p > 0.0 else [False] * len(batch))
        crashes = ([bool(scen.fault_rng.random() < crash.rate) for _ in batch]
                   if crash is not None else [False] * len(batch))
        for (finish, w), plan, drop, crashed in zip(batch, batch_plans, drops, crashes):
            clock = max(clock, finish)
            s = int(version - fetched_ver[w])
            if not drop:
                version += 1
            commits += 1
            rounds_done[w] += 1
            ref = np.zeros(W, bool)
            ref[w] = True
            fetched_ver[w] = version
            delay = 0.0
            if crashed:
                n_crashes += 1
                delay = crash.outage_rounds * env.phi_from_index(w, idx, jitter=False)
            if method == "ssp_s" and rounds_done[w] >= int(
                rounds_done[participants].min()
            ) + sim.ssp_threshold:
                blocked.append(w)
            elif rounds_done[w] < sim.rounds:
                schedule(w, clock + delay)
            if method == "ssp_s" and blocked:
                min_done = int(rounds_done[participants].min())
                still = []
                for bw in blocked:
                    if (rounds_done[bw] < min_done + sim.ssp_threshold
                            and rounds_done[bw] < sim.rounds):
                        ref[bw] = True
                        fetched_ver[bw] = version
                        schedule(bw, clock)
                    else:
                        still.append(bw)
                blocked = [b for b in still if rounds_done[b] < sim.rounds]
            workers.append(int(w))
            finishes.append(float(finish))
            push_seq.append(int(last_push[w]))
            staleness.append(s)
            versions.append(version)
            dropped.append(drop)
            refetch.append(ref)
            evals.append(commits % n_part == 0)
            clocks.append(clock)
            plans.append(plan)
        batch_starts.append(commits)

    return AsyncEventPlan(
        workers=np.asarray(workers, np.int64),
        finishes=np.asarray(finishes, np.float64),
        push_seq=np.asarray(push_seq, np.int64),
        staleness=np.asarray(staleness, np.int64),
        versions=np.asarray(versions, np.int64),
        dropped=np.asarray(dropped, bool),
        refetch=np.stack(refetch) if refetch else np.zeros((0, W), bool),
        evals=np.asarray(evals, bool),
        clocks=np.asarray(clocks, np.float64),
        batch_starts=np.asarray(batch_starts, np.int64),
        plans=plans,
        fault_ledger=(
            dict(drift_events=0, rounds_degraded=0, rounds_skipped=0,
                 workers_recovered=n_crashes, retry_total=n_crashes)
            if crash is not None else None
        ),
    )


def _run_async(sim: SimConfig, env: _Env) -> SimResult:
    """Replay the pre-simulated event plan, one window batch per fleet call.

    Resident (``masked``): the batch's rows take their fetched snapshots,
    train as one sub-stack and come back in one host copy; no host round
    trip is counted.  Per-worker (``sequential``, ``bucketed``): one job per
    commit from its fetched snapshot, and one ``async_merge`` round trip per
    merged commit.  The merges are ``AsyncServer``'s, in commit order."""
    W = sim.num_workers
    scen = ScenarioEngine(sim.scenario, W) if sim.scenario is not None else None
    participants = scen.static_participants() if scen is not None else np.arange(W)
    n_part = len(participants)
    plan = _plan_async_events(sim, env, scen, participants)
    if sim.engine == "fused":
        return run_async_fused(sim, env, scen, participants, plan)

    resident = sim.engine == "masked"
    idx = full_index(env.space)
    global_params = params_to_numpy(env.base_params)
    rb_cfg = sim.robust if sim.robust is not None and sim.robust.any_active else None
    server = AsyncServer(
        sim.method, global_params, W, cohort_size=n_part, fedasync_a=sim.fedasync_a,
        lr=sim.lr, dcasgd_lambda=sim.dcasgd_lambda, dcasgd_m=sim.dcasgd_m,
        clip_norm=rb_cfg.clip if rb_cfg is not None else None,
        quarantine=rb_cfg.quarantine if rb_cfg is not None else None,
    )
    # the server rebinds a fresh dict per commit, so snapshots are references
    fetched = [dict(global_params) for _ in range(W)]
    state = None
    pad_steps = None
    if resident:
        shard_x, shard_y = zip(*(env.shard_xy(w) for w in range(W)))
        state = env.fleet.init_state(env.base_params, list(shard_x), list(shard_y))
        pad_steps = max(
            plan_steps(len(env.shards[w]), sim.batch_size, sim.local_epochs) for w in participants
        )
    # async commits move base-shape payloads (workers never prune)
    commit_bytes = 2.0 * sum(int(np.prod(s)) * 4 for s in env.base_shapes.values())
    comm_bytes = 0.0
    merge_s = 0.0
    acc_time = [(0.0, _env_accuracy(env, env.base_params))]
    rt_base = roundtrip_total()

    for b in range(len(plan.batch_starts) - 1):
        s0, e0 = int(plan.batch_starts[b]), int(plan.batch_starts[b + 1])
        rows = [int(w) for w in plan.workers[s0:e0]]
        batch_plans = plan.plans[s0:e0]
        for p in batch_plans:   # async workers all train at the full index
            env.account_train(idx, p.shape[0])
        if resident:
            env.fleet.scatter_global_rows(state, rows, [fetched[w] for w in rows])
            _, pulled = env.fleet.train_rows(state, rows, batch_plans, sim.lam,
                                             pad_steps=pad_steps, to_host=True)
            if pulled is None:
                # no-step plans (local_epochs <= 0): commit the fetched params
                trained_batch = [fetched[w] for w in rows]
            else:
                trained_batch = [{k: v[i] for k, v in pulled.items()} for i in range(len(rows))]
        else:
            jobs = []
            for w, p in zip(rows, batch_plans):
                x, y = env.shard_xy(w)
                jobs.append(FleetJob(worker=w, params=_to_device(fetched[w], env.device),
                                     index=idx, x=x, y=y, plan=p))
            trained_batch = [params_to_numpy(t) for t in env.fleet.train_all(jobs, sim.lam)]
        for i, trained in zip(range(s0, e0), trained_batch):
            w = int(plan.workers[i])
            if not plan.dropped[i]:
                t0 = _time.perf_counter()
                global_params = server.commit(w, trained, fetched[w], int(plan.staleness[i]))
                merge_s += _time.perf_counter() - t0
                if not resident:
                    # per-worker path: each merged commit crosses the host
                    # boundary as a whole param dict
                    tally_roundtrip("async_merge")
                comm_bytes += commit_bytes
            if server.version != int(plan.versions[i]):
                raise RuntimeError("async replay diverged from the pre-simulated event plan")
            for rw in np.flatnonzero(plan.refetch[i]):
                fetched[int(rw)] = dict(global_params)
            if plan.evals[i]:
                acc_time.append((float(plan.clocks[i]),
                                 _env_accuracy(env, _to_device(global_params, env.device))))

    clock = float(plan.clocks[-1]) if plan.num_events else 0.0
    final = _to_device(global_params, env.device)
    final_cost = env.cost_for_index(idx)
    result = _finalize(
        sim, env, acc_time, [], [], [], [1.0] * W, [final] * W, comm_bytes, merge_s, clock,
        global_params=final, host_roundtrips=roundtrip_total() - rt_base,
        flops_per_image_final=final_cost[0], blocks_per_image_final=final_cost[2],
        prune_events=[], scenario_rounds=[(0, n_part, 0, 0)] if scen is not None else [],
        fault_ledger={**(plan.fault_ledger or {}),
                      "quarantined_commits": int(server.rejected_commits)},
    )
    result.host_pull_s = env.fleet.pull_walltime_s
    return result


def _finalize(sim, env, acc_time, het_traj, sim_traj, upd_times, retentions,
              worker_params, comm_bytes, server_overhead, clock,
              global_params, host_roundtrips, flops_per_image_final,
              blocks_per_image_final, prune_events, scenario_rounds,
              fault_ledger, fused_chunks: int = 0) -> SimResult:
    accs = np.array([a for _, a in acc_time])
    times = np.array([t for t, _ in acc_time])
    best = int(np.argmax(accs))
    param_sizes = [sum(v.numel() for v in p.values()) for p in worker_params]
    flops = [cnn_flops(p, sim.cnn) for p in worker_params]
    full_size = sum(v.numel() for v in env.base_params.values())
    if sim.mesh is not None:
        n_devices = int(np.prod(list(sim.mesh.shape.values())))
        fleet_axis_size = int(sim.mesh.shape[sim.fleet_axis])
        shard_spec = fleet_pspec(sim.fleet_axis)
    else:
        n_devices, fleet_axis_size, shard_spec = 1, 1, None
    return SimResult(
        method=sim.method,
        acc_time=acc_time,
        final_acc=float(accs[-1]),
        best_acc=float(accs[best]),
        best_acc_time=float(times[best]),
        total_time=float(clock),
        het_traj=het_traj,
        retentions=retentions,
        param_reduction=1.0 - float(np.mean(param_sizes)) / full_size,
        flops_reduction=1.0 - float(np.mean(flops)) / env.full_flops,
        comm_bytes=comm_bytes,
        server_overhead_s=server_overhead,
        recompiles=env.trainer.compile_count,
        similarity_traj=sim_traj,
        update_times=upd_times,
        engine=sim.engine,
        batched_calls=env.fleet.batched_calls,
        host_roundtrips=host_roundtrips,
        host_dispatches=env.trainer.dispatch_count,
        compile_walltime_s=env.trainer.compile_walltime_s,
        prune_events=prune_events,
        scenario_rounds=scenario_rounds,
        **fault_ledger,
        bucket_sizes=sorted(env.fleet.buckets_used),
        compute=sim.compute,
        flops_executed=env.flops_executed,
        flops_ideal=env.flops_ideal,
        blocks_executed=env.blocks_executed,
        images_trained=env.images_trained,
        train_steps=env.trainer.steps_run,
        flops_per_image_final=flops_per_image_final,
        blocks_per_image_final=blocks_per_image_final,
        device=str(env.device),
        global_params=params_to_numpy(global_params),
        fused_chunks=fused_chunks,
        n_devices=n_devices,
        fleet_axis_size=fleet_axis_size,
        shard_spec=shard_spec,
    )


def run_simulation(
    sim: SimConfig, base_params: Optional[Mapping[str, object]] = None
) -> SimResult:
    """Run one simulation.  ``base_params`` (a flat ``{path: array}`` dict in
    HWIO layout) replaces the seeded ``init_cnn`` draw."""
    t0 = _time.perf_counter()
    with ieee_f32():
        env = _Env(sim, base_params)
        if sim.method in ASYNC_METHODS:
            result = _run_async(sim, env)     # routes engine="fused" itself
        elif sim.engine == "fused":
            result = run_sync_fused(sim, env)
        else:
            result = _run_sync(sim, env)
        if env.device.type == "cuda":
            torch.cuda.synchronize(env.device)
    result.walltime_s = _time.perf_counter() - t0
    return result
