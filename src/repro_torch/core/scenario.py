"""Per-round participation events.

Port of ``RoundEvents`` and ``full_participation`` from
``repro/core/scenario.py``.  Client sampling, dropout, churn and faults
(``SimConfig.scenario``) are not ported yet: every round is full
participation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RoundEvents", "full_participation"]


@dataclasses.dataclass
class RoundEvents:
    """One round's participation outcome over the fixed worker slots."""

    active: np.ndarray    # bool [W]: sampled to train this round
    dropped: np.ndarray   # bool [W]: subset of active that never reports

    @property
    def submitters(self) -> np.ndarray:
        return self.active & ~self.dropped


def full_participation(num_workers: int) -> RoundEvents:
    return RoundEvents(
        active=np.ones(num_workers, dtype=bool), dropped=np.zeros(num_workers, dtype=bool)
    )
