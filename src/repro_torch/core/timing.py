"""Update-time and heterogeneity model (AdaptCL Eq. 4, 6, 7, 8).

Port of ``repro/core/timing.py`` (host numpy, float64).  Bandwidths are
assigned so that update times spread uniformly between the fastest worker
and ``sigma`` times the fastest:

    phi_w = (2*s_model/B_max + t_train) * (1 + (sigma-1)/(W-1) * (W-w))   (Eq. 6)
    B_w   = 2*s_model / (phi_w - t_train)                                  (Eq. 7)
    H     = 1 - 1/(W-1) * sum_w 1/(1 + (sigma-1)/(W-1)*(W-w))              (Eq. 8)

The same channel model simulates a worker's update time as a function of
its retention ratio gamma, ``phi_w(gamma) = 2 * s_model(gamma) / B_w +
t_train(gamma)`` (``ChannelModel``); ``train_sens`` in [0, 1] interpolates
between a train time insensitive to pruning (GPU-like) and one proportional
to FLOPs (CPU-like), the paper's Appendix E.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np

__all__ = [
    "ChannelModel",
    "HeterogeneityConfig",
    "drift_multiplier",
    "heterogeneity_closed_form",
    "heterogeneity_from_times",
    "make_bandwidths",
]


def drift_multiplier(
    round_t: int, start_round: int, factor: float, ramp_rounds: int = 1
) -> float:
    """Capability-drift update-time multiplier at 1-based round ``round_t``:
    1 before ``start_round``, ``factor`` from ``start_round + ramp_rounds -
    1`` on, linear in between (``ramp_rounds == 1`` is a jump).  Pure: it
    consumes no RNG stream."""
    if round_t < start_round:
        return 1.0
    if ramp_rounds <= 1 or round_t >= start_round + ramp_rounds - 1:
        return float(factor)
    frac = (round_t - start_round + 1) / float(ramp_rounds)
    return float(1.0 + (factor - 1.0) * frac)


@dataclasses.dataclass(frozen=True)
class HeterogeneityConfig:
    num_workers: int = 10
    sigma: float = 2.0        # longest/shortest update-time ratio
    # bytes/s of the fastest worker.  None => auto-scale so that
    # comm_fast = comm_ratio * t_train (the paper's comm-dominated regime
    # regardless of simulated model size).
    bandwidth_max: float | None = None
    comm_ratio: float = 3.0


def heterogeneity_from_times(phis: Sequence[float]) -> float:
    """H = 1 - 1/(W-1) * sum_{w != argmin} phi_min/phi_w   (Eq. 4)."""
    phis = np.asarray(phis, dtype=np.float64)
    if phis.size < 2:
        return 0.0
    phi_min = phis.min()
    others = np.delete(phis, int(phis.argmin()))
    return float(1.0 - np.mean(phi_min / others))


def heterogeneity_closed_form(W: int, sigma: float) -> float:
    """Eq. 8: H of the uniform spread the experiments use."""
    if W < 2:
        return 0.0   # a lone worker is its own fastest peer (as in Eq. 4)
    ws = np.arange(1, W, dtype=np.float64)   # w = 1..W-1 (worker W is fastest)
    return float(1.0 - np.mean(1.0 / (1.0 + (sigma - 1.0) / (W - 1) * (W - ws))))


def make_bandwidths(
    cfg: HeterogeneityConfig, model_bytes: float, t_train: float
) -> List[float]:
    """Eq. 6/7: bandwidths giving uniformly spread update times.  The last
    worker is the fastest."""
    W, sigma = cfg.num_workers, cfg.sigma
    bmax = cfg.bandwidth_max
    if bmax is None:
        bmax = 2.0 * model_bytes / (cfg.comm_ratio * max(t_train, 1e-9))
    phi_fast = 2.0 * model_bytes / bmax + t_train
    if W == 1:
        return [bmax]
    bws = []
    for w in range(1, W + 1):
        phi_w = phi_fast * (1.0 + (sigma - 1.0) / (W - 1) * (W - w))
        bws.append(2.0 * model_bytes / (phi_w - t_train))
    return bws


@dataclasses.dataclass
class ChannelModel:
    """Per-worker update-time simulator phi_w(gamma).

    ``model_bytes_fn``: gamma -> payload bytes of the reconfigured sub-model;
    ``flops_fn``: gamma -> per-round training FLOPs of the sub-model;
    ``train_sens``: 0 = train time insensitive to pruning, 1 = proportional
    to FLOPs; ``jitter``: multiplicative log-normal noise std per
    observation."""

    bandwidths: Sequence[float]
    t_train_full: float
    model_bytes_fn: Callable[[float], float]
    flops_fn: Callable[[float], float]
    train_sens: float = 0.0
    jitter: float = 0.0

    def train_time(self, gamma: float) -> float:
        rel = self.flops_fn(gamma) / max(self.flops_fn(1.0), 1e-30)
        return self.t_train_full * ((1.0 - self.train_sens) + self.train_sens * rel)

    def comm_time(self, worker: int, gamma: float) -> float:
        return 2.0 * self.model_bytes_fn(gamma) / self.bandwidths[worker]

    def update_time(
        self, worker: int, gamma: float, rng: np.random.Generator | None = None
    ) -> float:
        phi = self.comm_time(worker, gamma) + self.train_time(gamma)
        if self.jitter > 0.0 and rng is not None:
            phi *= float(np.exp(rng.normal(0.0, self.jitter)))
        return phi
