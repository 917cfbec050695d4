"""Scenario layer: client sampling, dropout, churn, and the fault overlay.

Port of ``repro/core/scenario.py`` (host numpy, no device).  Each round's participation is a ``RoundEvents`` record —
boolean masks over a FIXED worker slot space — so the resident masked
engine applies it as row selections of its ``[W, ...]`` stacks and device
shapes never change.  Semantics (implemented by
``core.simulation._run_sync``):

* **sampling** — ``clip(round(participation * W), min_participants, W)``
  workers drawn uniformly without replacement train and submit each round;
  the rest idle and keep their sub-model identity;
* **dropout** — each sampled worker independently misses the deadline with
  probability ``dropout`` (one submitter always survives); if anyone
  dropped, the round costs ``timeout_factor`` x the slowest received update;
* **churn** — each slot is replaced with probability ``churn`` at round
  start: full sub-model, fresh data shard, fresh pruned-rate history, DGC
  residual and momentum row;
* **schedule** — explicit per-round events (rounds past the schedule are
  full participation);
* **skew** — Dirichlet label skew of the initial shards
  (``data.synthetic.partition_dirichlet``);
* **faults** — the ``core.faults`` overlay (drift, crash, outage, wave, and
  the byzantine and channel draws).

The RNG order is the contract: ``ScenarioEngine.rng`` (seed + 9173) takes
the churn draw, the cohort ``choice``, the dropout draw, then one
``fresh_shard`` per joined slot in ascending order; ``fault_rng`` (seed +
40961) takes the crash, byzantine and channel blocks.  ``draw_all``
replays the same order into a ``ScenarioPlan``.

The async schedulers draw their cohort once, at run start
(``static_participants``, one ``rng.choice``), and replay a whole
pre-simulated event stream (``AsyncEventPlan``, built by
``core.simulation._plan_async_events``).  ``shard_cohorts`` splits a cohort
over the mesh-sharded fleet's shards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .faults import FaultConfig

__all__ = [
    "AsyncEventPlan",
    "FaultConfig",
    "RoundEvents",
    "ScenarioConfig",
    "ScenarioEngine",
    "ScenarioPlan",
    "full_participation",
    "shard_cohorts",
]


def shard_cohorts(rows: Sequence[int], num_workers: int, num_shards: int) -> List[np.ndarray]:
    """A sampled cohort's global slot ids as per-shard local row sets under
    the mesh-sharded fleet's contiguous layout (shard ``s`` owns slots
    ``[s * W_local, (s+1) * W_local)``); ids keep their draw order within a
    shard, and an id outside the fleet raises."""
    from .fleet import global_to_shard_local   # deferred: fleet imports torch

    shard_ids, local = global_to_shard_local(rows, num_workers, num_shards)
    return [np.asarray(local[shard_ids == s], np.int64) for s in range(num_shards)]


@dataclasses.dataclass
class RoundEvents:
    """One round's participation outcome over the fixed worker slots.

    The fault fields default to ``None``/``False`` and stay that way on a
    fault-free run, so pre-feature three-field constructions (tests,
    scripted schedules) and the fault-free fast path are untouched."""

    active: np.ndarray    # bool [W]: sampled to train this round
    dropped: np.ndarray   # bool [W]: subset of active that never reports
    joined: np.ndarray    # bool [W]: slot churned at round start (fresh worker)
    # --- fault overlay (core.faults), None/False when faults are off ---
    offline: Optional[np.ndarray] = None    # bool [W]: crashed / region dark
    recovered: Optional[np.ndarray] = None  # bool [W]: back online this round
    recovering: Optional[np.ndarray] = None  # bool [W]: re-joining, no aggreg.
    drift_mult: Optional[np.ndarray] = None  # f64 [W]: update-time multiplier
    skip: bool = False          # round skipped: submitters < min_participants
    degraded: bool = False      # aggregated a fault-reduced partial cohort
    drift_changed: bool = False  # drift multiplier changed at this round
    # --- adversarial / lossy-channel overlay, None when those families off ---
    byz: Optional[np.ndarray] = None        # bool [W]: compromised this round
    delivered: Optional[np.ndarray] = None  # bool [W]: commit survived channel
    dup: Optional[np.ndarray] = None        # bool [W]: delivered twice
    corrupt: Optional[np.ndarray] = None    # bool [W]: payload garbled
    retries: Optional[np.ndarray] = None    # int64 [W]: failed uplink attempts

    @property
    def submitters(self) -> np.ndarray:
        sub = self.active & ~self.dropped
        if self.recovering is not None:
            sub = sub & ~self.recovering
        return sub


def full_participation(num_workers: int) -> RoundEvents:
    on = np.ones(num_workers, dtype=bool)
    off = np.zeros(num_workers, dtype=bool)
    return RoundEvents(active=on, dropped=off.copy(), joined=off.copy())


@dataclasses.dataclass
class ScenarioConfig:
    participation: float = 1.0      # C: fraction of workers sampled per round
    dropout: float = 0.0            # P(sampled worker misses the deadline)
    churn: float = 0.0              # P(slot replaced at round start)
    min_participants: int = 1
    timeout_factor: float = 1.5     # straggler deadline multiplier on drop
    seed: int = 0
    # explicit per-round events (tests / reproducible sweeps); overrides draws
    schedule: Optional[Sequence[RoundEvents]] = None
    # scripted fault world (core.faults): capability drift, crash/recovery,
    # regional outages, participation waves, Byzantine workers, lossy
    # channels.  None => pre-feature behavior, bit for bit (zero extra RNG
    # draws on any stream).
    faults: Optional[FaultConfig] = None
    # Non-IID shard skew: Dirichlet label-concentration parameter for the
    # initial shard assignment (lower = more skewed; None = the default
    # sorted-split partitioner).  Applied once before any engine runs, so it
    # is engine-identical by construction; churned-in shards stay uniform.
    skew: Optional[float] = None


class ScenarioEngine:
    """Draws per-round :class:`RoundEvents` from a dedicated RNG stream.

    The stream is independent of the simulator's data/jitter RNG, so the same
    scenario unfolds identically under every fleet engine — which is what the
    cross-engine scenario-equivalence tests pin down."""

    def __init__(self, cfg: ScenarioConfig, num_workers: int):
        if not (0.0 < cfg.participation <= 1.0):
            raise ValueError(f"participation {cfg.participation} outside (0, 1]")
        if not (0.0 <= cfg.dropout < 1.0):
            raise ValueError(f"dropout {cfg.dropout} outside [0, 1)")
        if not (0.0 <= cfg.churn < 1.0):
            raise ValueError(f"churn {cfg.churn} outside [0, 1)")
        if cfg.min_participants < 1:
            raise ValueError(f"min_participants {cfg.min_participants} must be >= 1")
        if cfg.timeout_factor < 1.0:
            raise ValueError(
                f"timeout_factor {cfg.timeout_factor} must be >= 1.0: the "
                "straggler deadline is a multiplier on the slowest received "
                "update, and a factor below 1 would end the round before "
                "its own submitters finish"
            )
        if cfg.skew is not None and not (cfg.skew > 0.0):
            raise ValueError(f"scenario skew {cfg.skew} must be > 0")
        if cfg.faults is not None:
            if cfg.faults.drift is not None and cfg.faults.drift.worker >= num_workers:
                raise ValueError(
                    f"drift worker {cfg.faults.drift.worker} outside the "
                    f"{num_workers}-slot pool"
                )
            if cfg.faults.outage is not None and cfg.faults.outage.slot_hi > num_workers:
                raise ValueError(
                    f"outage slots [{cfg.faults.outage.slot_lo}, "
                    f"{cfg.faults.outage.slot_hi}) outside the "
                    f"{num_workers}-slot pool"
                )
            byz = cfg.faults.byzantine
            if byz is not None and byz.workers is not None and max(byz.workers) >= num_workers:
                raise ValueError(
                    f"byzantine workers {byz.workers} outside the "
                    f"{num_workers}-slot pool"
                )
        self.cfg = cfg
        self.W = num_workers
        self.rng = np.random.default_rng(cfg.seed + 9173)
        # Dedicated fault stream: crash draws come from here (one [W] vector
        # per round, round order), NEVER from self.rng — so enabling faults
        # does not perturb the sampling/dropout/churn stream, and a
        # fault-free run consumes zero draws from either stream for faults.
        self.fault_rng = np.random.default_rng(cfg.seed + 40961)
        self._faults_on = cfg.faults is not None and cfg.faults.any_active
        # crash/outage state machine: worker w is offline while
        # round < _offline_until[w], then re-joining (trains, refetches, not
        # aggregated) while round < _recover_until[w].
        self._offline_until = np.zeros(num_workers, dtype=np.int64)
        self._recover_until = np.zeros(num_workers, dtype=np.int64)
        self._prev_offline = np.zeros(num_workers, dtype=bool)

    def draw(self, round_t: int) -> RoundEvents:
        """Events for 1-based round ``round_t``."""
        cfg, W = self.cfg, self.W
        if cfg.schedule is not None:
            if round_t - 1 < len(cfg.schedule):
                ev = cfg.schedule[round_t - 1]
                ev = RoundEvents(
                    active=np.asarray(ev.active, bool).copy(),
                    dropped=np.asarray(ev.dropped, bool).copy(),
                    joined=np.asarray(ev.joined, bool).copy(),
                )
                if not ev.active.any():
                    raise ValueError(
                        f"schedule round {round_t} samples no workers"
                    )
                if not ev.submitters.any():
                    # same invariant as the random path: the timeout never
                    # starves the round of all submitters
                    ev.dropped[np.flatnonzero(ev.active)[0]] = False
            else:
                ev = full_participation(W)
        else:
            joined = self.rng.random(W) < cfg.churn
            k = self.cohort_size(round_t)
            active = np.zeros(W, dtype=bool)
            active[self.rng.choice(W, size=k, replace=False)] = True
            dropped = active & (self.rng.random(W) < cfg.dropout)
            if dropped.all() or not (active & ~dropped).any():
                # straggler timeout never starves the round: keep one submitter
                dropped[np.flatnonzero(active)[0]] = False
            ev = RoundEvents(active=active, dropped=dropped, joined=joined)
        if self._faults_on:
            ev = self._apply_faults(round_t, ev)
        return ev

    def _apply_faults(self, round_t: int, ev: RoundEvents) -> RoundEvents:
        """Overlay the scripted fault world onto one round's base draw.

        Runs AFTER the base draw so the sampling/dropout/churn stream is
        byte-identical with or without faults; the only stochastic family
        (crash) draws one [W] vector per round from the dedicated
        ``fault_rng``.  The fault state machine advances here — ``draw``
        must be called once per round in order (both the lazy loop and
        ``draw_all`` do)."""
        faults = self.cfg.faults
        base_active = ev.active.copy()
        outage_now = np.zeros(self.W, dtype=bool)
        if faults.outage is not None and faults.outage.covers(round_t):
            outage_now[faults.outage.slot_lo:faults.outage.slot_hi] = True
        if faults.crash is not None:
            crash_now = self.fault_rng.random(self.W) < faults.crash.rate
            # only currently-online workers can crash (a dark region or an
            # already-crashed worker has nothing left to lose this round)
            crash_now &= (round_t >= self._offline_until) & ~outage_now
            hit = np.flatnonzero(crash_now)
            self._offline_until[hit] = round_t + faults.crash.outage_rounds
            self._recover_until[hit] = (
                self._offline_until[hit] + faults.crash.recovery_rounds
            )
        offline = (round_t < self._offline_until) | outage_now
        recovered = ~offline & self._prev_offline
        recovering = ~offline & (round_t < self._recover_until)
        self._prev_offline = offline
        ev.offline = offline
        ev.recovered = recovered
        ev.recovering = recovering
        ev.active = ev.active & ~offline
        ev.dropped = ev.dropped & ev.active
        ev.joined = ev.joined & ~offline
        if faults.drift is not None:
            ev.drift_mult = self.drift_mults(round_t)
            ev.drift_changed = self.drift_changed(round_t)
        if faults.byzantine is not None:
            # fixed compromised set: deterministic, zero RNG; fractional set:
            # one [W] block per round, drawn unconditionally so the stream
            # never depends on who was sampled this round
            if faults.byzantine.workers is not None:
                byz = np.zeros(self.W, dtype=bool)
                byz[list(faults.byzantine.workers)] = True
            else:
                byz = self.fault_rng.random(self.W) < faults.byzantine.fraction
            ev.byz = byz
        if faults.channel is not None:
            ch = faults.channel
            # fixed draw block per round: attempts, then dup, then corrupt
            fails = self.fault_rng.random((self.W, ch.max_retries + 1)) < ch.drop
            dup_u = self.fault_rng.random(self.W)
            corrupt_u = self.fault_rng.random(self.W)
            delivered = ~fails.all(axis=1)
            # retries = failed attempts consumed: attempts before the first
            # success, or the whole retry budget when every attempt failed
            first_ok = np.argmax(~fails, axis=1)
            ev.retries = np.where(delivered, first_ok, ch.max_retries).astype(np.int64)
            ev.delivered = delivered
            ev.dup = delivered & (dup_u < ch.dup)
            ev.corrupt = delivered & (corrupt_u < ch.corrupt)
        n_sub = int(ev.submitters.sum())
        if n_sub < self.cfg.min_participants:
            # graceful degradation floor: too few survivors to aggregate —
            # skip the round (virtual clock still advances, global untouched)
            ev.skip = True
        else:
            ev.degraded = bool(
                (base_active & offline).any() or (ev.active & recovering).any()
                or (ev.delivered is not None
                    and (ev.submitters & ~ev.delivered).any())
            )
        return ev

    def drift_mults(self, round_t: int) -> np.ndarray:
        """Per-worker update-time multipliers in force at ``round_t``.

        Pure in ``round_t`` (no state, no RNG) so the fused engine's
        chunk-boundary scan can probe future rounds without perturbing the
        stream."""
        mults = np.ones(self.W, dtype=np.float64)
        drift = self.cfg.faults.drift if self.cfg.faults is not None else None
        if drift is not None:
            mults[drift.worker] = drift.mult_at(round_t)
        return mults

    def drift_changed(self, round_t: int) -> bool:
        """True when the drift multiplier changes AT ``round_t`` — the
        trigger for prune-rate re-learning (re-enter Alg. 2)."""
        drift = self.cfg.faults.drift if self.cfg.faults is not None else None
        if drift is None or round_t < 1:
            return False
        return drift.mult_at(round_t) != drift.mult_at(round_t - 1)

    def cohort_size(self, round_t: Optional[int] = None) -> int:
        """Sampled cohort size: ``clip(round(C * W), min_participants, W)``
        (the reference's async static cohort uses the same formula).  With a
        diurnal wave fault and a round index, C becomes the time-varying
        C(t)."""
        cfg = self.cfg
        part = cfg.participation
        if (
            round_t is not None
            and cfg.faults is not None
            and cfg.faults.wave is not None
        ):
            part = min(part * cfg.faults.wave.factor_at(round_t), 1.0)
        return int(np.clip(round(part * self.W),
                           cfg.min_participants, self.W))

    def static_participants(self) -> np.ndarray:
        """Slot ids of an ASYNC run's cohort, drawn once at run start: a
        ``cohort_size()`` subset joins the event loop, the rest idles for
        the whole run.  Sorted ascending, so the initial schedule runs in
        slot order as under full participation."""
        k = self.cohort_size()
        return np.sort(self.rng.choice(self.W, size=k, replace=False)).astype(np.int64)

    def fresh_shard(self, size: int, train_len: int) -> np.ndarray:
        """Index set for a churned-in worker (uniform over the task's pool)."""
        return self.rng.choice(train_len, size=size, replace=False).astype(np.int64)

    def draw_all(
        self,
        rounds: int,
        shard_sizes: Optional[Sequence[int]] = None,
        train_len: int = 0,
    ) -> "ScenarioPlan":
        """Pre-draw the ENTIRE run's events (the reference's fused engine
        runs from such a plan).

        Consumes the scenario RNG stream in exactly the per-round order of
        the lazy sync loop — ``draw(t)`` then one ``fresh_shard`` per joined
        slot in ascending slot order — so a pre-drawn plan unfolds
        *identically* to round-by-round draws under every engine.  Fresh
        shards for churned slots are drawn here too (they interleave with
        the event draws on the shared stream); ``shard_sizes``/``train_len``
        are only needed when churn is enabled."""
        events: List[RoundEvents] = []
        fresh: List[Dict[int, np.ndarray]] = []
        for t in range(1, rounds + 1):
            ev = self.draw(t)
            shards: Dict[int, np.ndarray] = {}
            for w in np.flatnonzero(ev.joined):
                if shard_sizes is None:
                    raise ValueError("draw_all needs shard_sizes when churn > 0")
                shards[int(w)] = self.fresh_shard(int(shard_sizes[w]), train_len)
            events.append(ev)
            fresh.append(shards)
        return ScenarioPlan(events=events, fresh_shards=fresh)


@dataclasses.dataclass
class ScenarioPlan:
    """A whole run's pre-drawn scenario: per-round events + churn shards.

    ``as_arrays`` stacks the boolean masks into ``[R, W]`` matrices — the
    form the fused engine uploads to device (submitter weights, activity
    masks) so the scan consumes one row per fused round."""

    events: List[RoundEvents]
    fresh_shards: List[Dict[int, np.ndarray]]

    def as_arrays(self) -> Dict[str, np.ndarray]:
        return {
            "active": np.stack([e.active for e in self.events]),
            "dropped": np.stack([e.dropped for e in self.events]),
            "joined": np.stack([e.joined for e in self.events]),
            "submitters": np.stack([e.submitters for e in self.events]),
        }

    @staticmethod
    def full(rounds: int, num_workers: int) -> "ScenarioPlan":
        return ScenarioPlan(
            events=[full_participation(num_workers) for _ in range(rounds)],
            fresh_shards=[{} for _ in range(rounds)],
        )


@dataclasses.dataclass
class AsyncEventPlan:
    """A whole async run's pre-simulated discrete-event stream.

    Built by ``simulation._plan_async_events`` from a host replay of the
    heap loop with training removed: async workers never prune, so event
    timing does not depend on trained params.  Every array is indexed by
    event ``i`` in heap pop order (= commit order); ``batch_starts``
    delimits the window batches the engines train as one call.
    ``push_seq`` is the order each event was pushed into the pending queue
    (what a device-side queue pop would replay)."""

    workers: np.ndarray        # int64 [E]: committing worker, heap pop order
    finishes: np.ndarray       # f64 [E]: event finish time (heap key)
    push_seq: np.ndarray       # int64 [E]: global push counter at schedule()
    staleness: np.ndarray      # int64 [E]: server.version - fetched_ver[w]
    versions: np.ndarray       # int64 [E]: server version AFTER the event
    dropped: np.ndarray        # bool [E]: commit timed out (no merge)
    refetch: np.ndarray        # bool [E, W]: rows refetching the new global
    evals: np.ndarray          # bool [E]: accuracy eval after this commit
    clocks: np.ndarray         # f64 [E]: running-max virtual clock
    batch_starts: np.ndarray   # int64 [B+1]: window-batch event offsets
    plans: List[np.ndarray]    # per-event batch plans, env.rng draw order
    # crash accounting baked at plan time (None when faults are off)
    fault_ledger: Optional[Dict[str, int]] = None

    @property
    def num_events(self) -> int:
        return len(self.workers)
