"""Fault-injection world model: scripted hostile-world events.

Port of ``repro/core/faults.py`` (pure dataclasses and numpy, no device).
Six families overlay the scenario layer (``ScenarioConfig.faults``):

* **capability drift** (``DriftConfig``) — one worker's update time jumps
  or ramps by ``factor`` at ``round`` (deterministic, zero RNG); a drift
  change re-enters Alg. 2 at the end of that round with the worker's
  (gamma, phi) history invalidated;
* **crash / recovery** (``CrashConfig``) — each online worker crashes per
  round with probability ``rate`` (the dedicated fault RNG stream), stays
  offline ``outage_rounds`` rounds, and spends ``recovery_rounds`` re-joining
  (trains and refetches, not aggregated); it returns with its last mask and
  restarts momentum and DGC residuals;
* **regional outage** (``OutageConfig``) — a contiguous slot range goes dark
  for a window of rounds; too few survivors (< ``min_participants``) skip
  the round (the clock waits out the straggler deadline), otherwise the
  round aggregates the partial cohort (degraded);
* **participation wave** (``WaveConfig``) — ``C(t) = C * (1 + amplitude *
  sin(2*pi*(t-1)/period))`` (deterministic);
* **Byzantine workers** (``ByzantineConfig``) — compromised slots send a
  sign-flipped, scaled or noised delta at the submission boundary;
* **a lossy channel** (``ChannelConfig``) — each upload is dropped per
  attempt and retried with a backoff on the update time (a commit lost
  after every retry does not aggregate), delivered twice, or garbled with
  noise.  Both act on per-worker deltas, so they need by_worker
  aggregation, run on every sync engine through the robust server
  (``aggregation.robust_submission_step_dev``), and are sync-only.

Deterministic families are pure functions of (config, round); the
stochastic ones draw from the fault stream (``ScenarioEngine.fault_rng``)
once per round in round order, and ``faults=None`` consumes zero draws.
``fault_ledger`` derives the run's fault ledger from the round events alone,
so every engine reports the same one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .timing import drift_multiplier

__all__ = [
    "ByzantineConfig",
    "ChannelConfig",
    "CrashConfig",
    "DriftConfig",
    "FaultConfig",
    "OutageConfig",
    "WaveConfig",
    "fault_ledger",
]


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """One worker's capability drifts: phi multiplies by ``factor``.

    ``mode="jump"`` switches at ``round``; ``mode="ramp"`` interpolates the
    multiplier linearly over ``ramp_rounds`` rounds starting at ``round``.
    ``factor > 1`` = the worker got slower, ``< 1`` = faster."""

    worker: int = 0
    round: int = 1          # first round the drifted capability is in force
    factor: float = 2.0     # update-time multiplier after the drift
    mode: str = "jump"      # "jump" | "ramp"
    ramp_rounds: int = 1

    def __post_init__(self):
        if self.worker < 0:
            raise ValueError(f"drift worker {self.worker} must be >= 0")
        if self.round < 1:
            raise ValueError(f"drift round {self.round} must be >= 1")
        if not (self.factor > 0.0):
            raise ValueError(f"drift factor {self.factor} must be > 0")
        if self.mode not in ("jump", "ramp"):
            raise ValueError(f"drift mode {self.mode!r} not in jump/ramp")
        if self.ramp_rounds < 1:
            raise ValueError(
                f"drift ramp_rounds {self.ramp_rounds} must be >= 1"
            )

    def mult_at(self, round_t: int) -> float:
        """Update-time multiplier in force at 1-based round ``round_t``."""
        return drift_multiplier(
            round_t, self.round, self.factor,
            ramp_rounds=self.ramp_rounds if self.mode == "ramp" else 1,
        )


@dataclasses.dataclass(frozen=True)
class CrashConfig:
    """Per-round worker crashes with offline span + staged recovery."""

    rate: float = 0.05        # P(online worker crashes this round)
    outage_rounds: int = 2    # rounds fully offline after a crash
    recovery_rounds: int = 1  # re-join rounds: train + refetch, no aggregation

    def __post_init__(self):
        if not (0.0 <= self.rate < 1.0):
            raise ValueError(f"crash rate {self.rate} outside [0, 1)")
        if self.outage_rounds < 1:
            raise ValueError(
                f"crash outage_rounds {self.outage_rounds} must be >= 1"
            )
        if self.recovery_rounds < 0:
            raise ValueError(
                f"crash recovery_rounds {self.recovery_rounds} must be >= 0"
            )


@dataclasses.dataclass(frozen=True)
class OutageConfig:
    """A contiguous slot range offline for rounds [start, start + length)."""

    start: int = 1        # first affected round (1-based)
    length: int = 1       # rounds the region stays dark
    slot_lo: int = 0      # first affected worker slot
    slot_hi: int = 1      # one past the last affected slot

    def __post_init__(self):
        if self.start < 1:
            raise ValueError(f"outage start {self.start} must be >= 1")
        if self.length < 1:
            raise ValueError(f"outage length {self.length} must be >= 1")
        if not (0 <= self.slot_lo < self.slot_hi):
            raise ValueError(
                f"outage slots [{self.slot_lo}, {self.slot_hi}) must be a "
                "non-empty ascending range"
            )

    @staticmethod
    def for_shard(
        start: int, length: int, shard: int, num_workers: int, num_shards: int
    ) -> "OutageConfig":
        """Outage covering mesh shard ``shard``'s contiguous slot range.

        Matches the mesh-sharded fleet's layout (shard ``s`` owns slots
        ``[s * W_local, (s+1) * W_local)`` — the same algebra as
        ``scenario.shard_cohorts`` / ``fleet.global_to_shard_local``), so a
        "regional" outage takes out exactly one shard's row block."""
        if num_shards < 1 or num_workers % num_shards:
            raise ValueError(
                f"num_workers={num_workers} does not divide into "
                f"{num_shards} shards"
            )
        if not (0 <= shard < num_shards):
            raise ValueError(f"shard {shard} outside [0, {num_shards})")
        w_local = num_workers // num_shards
        return OutageConfig(
            start=start, length=length,
            slot_lo=shard * w_local, slot_hi=(shard + 1) * w_local,
        )

    def covers(self, round_t: int) -> bool:
        return self.start <= round_t < self.start + self.length


@dataclasses.dataclass(frozen=True)
class WaveConfig:
    """Diurnal participation wave: C(t) = C * (1 + amp * sin(2pi (t-1)/T))."""

    amplitude: float = 0.5
    period: int = 8

    def __post_init__(self):
        if not (0.0 < self.amplitude < 1.0):
            raise ValueError(
                f"wave amplitude {self.amplitude} outside (0, 1)"
            )
        if self.period < 2:
            raise ValueError(f"wave period {self.period} must be >= 2")

    def factor_at(self, round_t: int) -> float:
        return float(
            1.0 + self.amplitude * np.sin(
                2.0 * np.pi * (round_t - 1) / self.period
            )
        )


@dataclasses.dataclass(frozen=True)
class ByzantineConfig:
    """Compromised workers emit adversarial commits.

    The attack is a pure transform on the committed delta at the submission
    boundary: ``sign_flip`` sends ``-delta``, ``scale`` sends
    ``scale * delta`` (negative scale = sign-flip-and-amplify), ``noise``
    sends ``delta + noise_std * N(0, 1)`` (masked to the worker's live
    coordinates).  ``workers`` fixes the compromised slot set
    (deterministic, zero RNG); ``workers=None`` re-draws the set per round
    with probability ``fraction`` per slot from the fault RNG."""

    workers: Optional[Sequence[int]] = None
    fraction: float = 0.0
    mode: str = "sign_flip"   # "sign_flip" | "scale" | "noise"
    scale: float = -10.0      # multiplier for mode="scale"
    noise_std: float = 1.0    # std for mode="noise"

    def __post_init__(self):
        if self.workers is not None:
            ws = tuple(int(w) for w in self.workers)
            if not ws or any(w < 0 for w in ws):
                raise ValueError(
                    f"byzantine workers {self.workers!r} must be a "
                    "non-empty sequence of slots >= 0"
                )
            object.__setattr__(self, "workers", ws)
        if not (0.0 <= self.fraction <= 1.0):
            raise ValueError(
                f"byzantine fraction {self.fraction} outside [0, 1]"
            )
        if self.mode not in ("sign_flip", "scale", "noise"):
            raise ValueError(
                f"byzantine mode {self.mode!r} not in sign_flip/scale/noise"
            )
        if self.mode == "scale" and self.scale == 0.0:
            raise ValueError("byzantine scale must be nonzero")
        if not (self.noise_std > 0.0):
            raise ValueError(
                f"byzantine noise_std {self.noise_std} must be > 0"
            )


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Lossy uplink: drop/retry/backoff, duplicate delivery, corruption."""

    drop: float = 0.0          # P(one delivery attempt fails)
    dup: float = 0.0           # P(a delivered commit arrives twice)
    corrupt: float = 0.0       # P(a delivered payload is garbled)
    max_retries: int = 2       # extra attempts after the first failure
    retry_backoff: float = 0.5  # phi multiplier grows by this per retry
    corrupt_std: float = 10.0  # noise std applied to corrupted payloads

    def __post_init__(self):
        for field in ("drop", "dup", "corrupt"):
            v = getattr(self, field)
            if not (0.0 <= v < 1.0):
                raise ValueError(f"channel {field} {v} outside [0, 1)")
        if self.max_retries < 0:
            raise ValueError(
                f"channel max_retries {self.max_retries} must be >= 0"
            )
        if self.retry_backoff < 0.0:
            raise ValueError(
                f"channel retry_backoff {self.retry_backoff} must be >= 0"
            )
        if not (self.corrupt_std > 0.0):
            raise ValueError(
                f"channel corrupt_std {self.corrupt_std} must be > 0"
            )


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """The scripted fault world (``ScenarioConfig.faults``).

    Every family is optional; ``FaultConfig()`` (all ``None``) is
    bit-identical to ``faults=None`` — zero extra RNG draws on any stream."""

    drift: Optional[DriftConfig] = None
    crash: Optional[CrashConfig] = None
    outage: Optional[OutageConfig] = None
    wave: Optional[WaveConfig] = None
    byzantine: Optional[ByzantineConfig] = None
    channel: Optional[ChannelConfig] = None

    @property
    def any_active(self) -> bool:
        return any(
            f is not None
            for f in (self.drift, self.crash, self.outage, self.wave,
                      self.byzantine, self.channel)
        )


def fault_ledger(events: Sequence) -> Dict[str, int]:
    """The run-level fault ledger from a round-events sequence.

    One pure function of the (engine-independent) per-round events, used by
    every sync engine — so ``SimResult`` ledgers are identical across
    sequential / masked / fused by construction.  All zeros when no faults
    ran.  ``retry_total`` counts re-join attempts (rounds a recovering
    worker trained without counting toward aggregation) plus channel
    delivery retries; ``byz_commits`` / ``lost_commits`` / ``dup_commits``
    / ``corrupt_commits`` count per-round submission outcomes."""
    led = dict(
        drift_events=0, rounds_degraded=0, rounds_skipped=0,
        workers_recovered=0, retry_total=0,
        byz_commits=0, lost_commits=0, dup_commits=0, corrupt_commits=0,
    )
    for ev in events:
        led["drift_events"] += int(getattr(ev, "drift_changed", False))
        led["rounds_skipped"] += int(getattr(ev, "skip", False))
        led["rounds_degraded"] += int(getattr(ev, "degraded", False))
        rec = getattr(ev, "recovered", None)
        if rec is not None:
            led["workers_recovered"] += int(np.asarray(rec).sum())
        ring = getattr(ev, "recovering", None)
        if ring is not None:
            led["retry_total"] += int(
                (np.asarray(ring) & np.asarray(ev.active)).sum()
            )
        sub = np.asarray(ev.submitters)
        byz = getattr(ev, "byz", None)
        if byz is not None:
            led["byz_commits"] += int((np.asarray(byz) & sub).sum())
        retr = getattr(ev, "retries", None)
        if retr is not None:
            led["retry_total"] += int(np.asarray(retr)[sub].sum())
        delv = getattr(ev, "delivered", None)
        if delv is not None:
            led["lost_commits"] += int((~np.asarray(delv) & sub).sum())
            led["dup_commits"] += int(
                (np.asarray(ev.dup) & np.asarray(delv) & sub).sum()
            )
            led["corrupt_commits"] += int(
                (np.asarray(ev.corrupt) & np.asarray(delv) & sub).sum()
            )
    return led
