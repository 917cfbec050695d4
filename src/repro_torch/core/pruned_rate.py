"""Pruned-rate learning (AdaptCL Algorithm 2).

Port of ``repro/core/pruned_rate.py``, unchanged: host numpy in float64, so
both packages learn bit-identical pruned rates from identical histories.

The server models each worker's update time phi as a function of its model
retention ratio gamma using Newton divided-difference interpolation over the
observed history ``(gamma^0, phi^0) .. (gamma^n, phi^n)`` and *inverts* it at
the target time ``phi_min`` (the fastest worker's current update time).

Because we want ``gamma_target = f^{-1}(phi_min)``, we interpolate the inverse
directly: nodes are ``phi`` values, values are ``gamma`` values (Eq. 2 in the
paper).  The bootstrap rule (worker never pruned before) assumes
``phi = alpha * phi_now * gamma`` and yields
``P = (phi_now - phi_min) / (alpha * phi_now)`` (Alg. 2 line 9).

Pure Python/NumPy: this runs on the *server* and its cost is part of the
paper's "negligible overhead" claim (measured in benchmarks/run.py:overhead).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "PrunedRateConfig",
    "WorkerHistory",
    "newton_divided_differences",
    "newton_eval",
    "inverse_interpolate_gamma",
    "learn_pruned_rates",
]


@dataclasses.dataclass(frozen=True)
class PrunedRateConfig:
    """Controlling parameters of Alg. 2 (Tab. I)."""

    rho_max: float = 0.5     # maximum pruned rate per pruning
    rho_min: float = 0.02    # minimum pruned rate (skip overly tiny prunings)
    gamma_min: float = 0.1   # minimum model retention ratio
    alpha: float = 2.0       # bootstrap coefficient (phi ~ alpha*phi_now*gamma)
    max_history: int = 8     # cap interpolation order (Runge guard; paper: n stays 3-4)


@dataclasses.dataclass
class WorkerHistory:
    """Per-worker record of (retention ratio, averaged update time) pairs.

    ``gammas[i]``/``phis[i]`` is the i-th *pruning checkpoint*: the retention
    ratio in force and the update time averaged over the pruning interval
    (Appendix A: averaging over the PI rounds filters bandwidth noise).
    """

    gammas: List[float] = dataclasses.field(default_factory=list)
    phis: List[float] = dataclasses.field(default_factory=list)

    def record(self, gamma: float, phi: float) -> None:
        if not np.isfinite(gamma) or not np.isfinite(phi):
            raise ValueError(f"non-finite history point ({gamma}, {phi})")
        self.gammas.append(float(gamma))
        self.phis.append(float(phi))

    @property
    def pruned_before(self) -> bool:
        # First entry is the unpruned (gamma=1.0) measurement; a worker counts
        # as "pruned before" once it has >=2 distinct retention levels.
        return len({round(g, 12) for g in self.gammas}) >= 2

    def invalidate(self) -> None:
        """Drop the history: the worker's capability changed (fault-injection
        capability drift), so every recorded (gamma, phi) pair describes a
        machine that no longer exists.  The next ``learn_pruned_rates`` call
        re-enters Alg. 2 through the bootstrap path, exactly as if the
        worker had never been profiled."""
        self.gammas.clear()
        self.phis.clear()


def newton_divided_differences(xs: Sequence[float], ys: Sequence[float]) -> np.ndarray:
    """Return Newton divided-difference coefficients c_0..c_n for nodes xs.

    ``p(x) = c_0 + c_1 (x-x_0) + ... + c_n (x-x_0)...(x-x_{n-1})``
    """
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    if xs.ndim != 1 or xs.shape != ys.shape or xs.size == 0:
        raise ValueError("xs/ys must be equal-length 1-D, non-empty")
    n = xs.size
    coef = ys.copy()
    for j in range(1, n):
        denom = xs[j:] - xs[:-j]
        if np.any(np.abs(denom) < 1e-12):
            raise ZeroDivisionError("duplicate interpolation nodes")
        coef[j:] = (coef[j:] - coef[j - 1 : -1]) / denom
    return coef


def newton_eval(coef: np.ndarray, xs: Sequence[float], x: float) -> float:
    """Horner-style evaluation of the Newton form at x."""
    xs = np.asarray(xs, dtype=np.float64)
    acc = coef[-1]
    for k in range(len(coef) - 2, -1, -1):
        acc = acc * (x - xs[k]) + coef[k]
    return float(acc)


def _dedupe_nodes(phis: Sequence[float], gammas: Sequence[float]) -> Tuple[List[float], List[float]]:
    """Drop (phi, gamma) points whose phi collides with an earlier node.

    Newton interpolation needs distinct nodes; repeated measurements at the
    same update time carry no new information, keep the latest.
    """
    seen = {}
    for p, g in zip(phis, gammas):
        seen[round(float(p), 9)] = (float(p), float(g))
    pts = sorted(seen.values(), key=lambda t: t[0])
    return [p for p, _ in pts], [g for _, g in pts]


def inverse_interpolate_gamma(
    history: WorkerHistory, phi_target: float, max_history: int = 8
) -> float:
    """gamma_target = f^{-1}(phi_target) via Newton interpolation (Eq. 2)."""
    # The Runge guard keeps the *most recent* pruning checkpoints, so the
    # history must be truncated by recency BEFORE _dedupe_nodes sorts the
    # nodes by ascending phi (sorting first would keep the largest-phi nodes
    # — stale early measurements — forever).
    phis, gammas = _dedupe_nodes(
        history.phis[-max_history:], history.gammas[-max_history:]
    )
    if len(phis) == 0:
        raise ValueError("empty history")
    if len(phis) == 1:
        # Single point: proportional model through the origin.
        return gammas[0] * phi_target / phis[0]
    coef = newton_divided_differences(phis, gammas)
    return newton_eval(coef, phis, phi_target)


def learn_pruned_rates(
    histories: Sequence[WorkerHistory],
    gammas_now: Sequence[float],
    phis_now: Sequence[float],
    cfg: PrunedRateConfig = PrunedRateConfig(),
) -> List[float]:
    """AdaptCL Algorithm 2: one pruned rate P_w in [0, rho_max] per worker.

    Args:
      histories: per-worker (gamma, phi) history *including* the current point.
      gammas_now: current retention ratio per worker.
      phis_now: current (interval-averaged) update time per worker.
    """
    W = len(histories)
    if not (W == len(gammas_now) == len(phis_now)):
        raise ValueError("length mismatch")
    phi_min = float(min(phis_now))
    rates: List[float] = []
    for w in range(W):
        gamma_now = float(gammas_now[w])
        phi_now = float(phis_now[w])
        if histories[w].pruned_before:
            gamma_target = inverse_interpolate_gamma(
                histories[w], phi_min, cfg.max_history
            )
            gamma_target = max(gamma_target, cfg.gamma_min)
            # Guard: interpolation can extrapolate wildly; never *grow* the
            # model and never cut below gamma_min.
            gamma_target = min(gamma_target, gamma_now)
            if gamma_now - gamma_target < cfg.rho_min:
                gamma_target = gamma_now  # skip tiny prunings (Alg.2 line 5-6)
            p = (gamma_now - gamma_target) / gamma_now
        else:
            # Bootstrap: phi ~= alpha * phi_now * gamma  =>  line 9.
            p = (phi_now - phi_min) / (cfg.alpha * phi_now)
        p = float(np.clip(p, 0.0, cfg.rho_max))
        # Respect gamma_min even on the bootstrap path.
        if gamma_now * (1.0 - p) < cfg.gamma_min:
            p = max(0.0, 1.0 - cfg.gamma_min / gamma_now)
        if p < cfg.rho_min:
            p = 0.0
        rates.append(p)
    return rates
