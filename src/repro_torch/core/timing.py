"""Update-time and heterogeneity model (AdaptCL Eq. 4, 6, 7, 8).

Port of the parts of ``repro/core/timing.py`` the simulator uses (host
numpy, float64).  Bandwidths are assigned so that update times spread
uniformly between the fastest worker and ``sigma`` times the fastest:

    phi_w = (2*s_model/B_max + t_train) * (1 + (sigma-1)/(W-1) * (W-w))   (Eq. 6)
    B_w   = 2*s_model / (phi_w - t_train)                                  (Eq. 7)
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

__all__ = ["HeterogeneityConfig", "heterogeneity_from_times", "make_bandwidths"]


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
