"""One benchmark per paper table/figure (AdaptCL, Tab. II-IV/XIV/XVII,
Fig. 2/5/8), on the port.

Port of ``benchmarks/tables.py``: the same simulations, seeds and
``name,value,derived`` CSV rows, so both packages can be read side by side.
All experiments run on synthetic classification tasks: claims are
validated as orderings and ratios against the paper's own update-time model
(Eq. 6-8), not absolute CIFAR numbers.  Rounds are scaled T=150 -> 12 and
PI=10 -> 5 (``quick``: 8 and 4).

Each function takes a ``Settings``.  ``run.py`` builds it from its flags
and, as the reference does, from ``BENCH_QUICK=1`` in the environment.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.pruned_rate import PrunedRateConfig
from repro_torch.core.simulation import SimConfig, SimResult, run_simulation
from repro_torch.core.timing import HeterogeneityConfig, heterogeneity_closed_form
from repro_torch.models.cnn import CNNConfig

__all__ = [
    "Settings",
    "table2_main",
    "table4_heterogeneity",
    "fig2_principles",
    "fig5_aggregation",
    "fig8_convergence",
    "table14_interval",
    "table17_dgc",
    "overhead",
    "engines",
    "BENCHES",
]


@dataclasses.dataclass(frozen=True)
class Settings:
    """What every table shares: ``quick`` shrinks rounds and the prune
    interval, ``engine`` is the fleet engine, ``device`` where the runs go,
    ``cnn`` the model (None: ``SimConfig``'s default, the tables' own)."""

    quick: bool = False
    engine: str = "sequential"
    device: str = "cuda"
    cnn: Optional[CNNConfig] = None

    @property
    def rounds(self) -> int:
        return 8 if self.quick else 12

    @property
    def pi(self) -> int:
        return 4 if self.quick else 5


def _row(name: str, value, derived: str = ""):
    print(f"{name},{value},{derived}")


def _run(s: Settings, method: str, sigma: float = 2.0, noniid: float = 0.0,
         **kw) -> SimResult:
    base = dict(
        method=method,
        rounds=s.rounds,
        prune_interval=s.pi,
        noniid_s=noniid,
        het=HeterogeneityConfig(sigma=sigma),
        engine=s.engine,
        seed=7,
        device=s.device,
    )
    if s.cnn is not None:
        base["cnn"] = s.cnn
    base.update(kw)
    return run_simulation(SimConfig(**base))


def table2_main(s: Settings) -> Dict[str, SimResult]:
    """Tab. II analogue: six frameworks, IID + Non-IID(s=80)."""
    methods = ["fedavg", "fedavg_s", "fedasync_s", "ssp_s", "dcasgd_s", "adaptcl"]
    out = {}
    for dist, noniid in (("iid", 0.0), ("noniid", 80.0)):
        for m in methods:
            r = _run(s, m, noniid=noniid)
            out[f"{m}_{dist}"] = r
            _row(
                f"table2/{dist}/{m}/acc", f"{r.best_acc:.4f}",
                f"time_s={r.total_time:.1f};final={r.final_acc:.4f}",
            )
    for dist in ("iid", "noniid"):
        fed, ada = out[f"fedavg_s_{dist}"], out[f"adaptcl_{dist}"]
        _row(
            f"table2/{dist}/adaptcl_speedup", f"{fed.total_time / ada.total_time:.2f}x",
            f"dacc={ada.best_acc - fed.best_acc:+.4f};param_red={ada.param_reduction:.2%}",
        )
    return out


def table4_heterogeneity(s: Settings):
    """Tab. IV analogue: speedup/acc vs heterogeneity sigma (Non-IID)."""
    for sigma in (2.0, 5.0, 10.0, 20.0):
        fed = _run(s, "fedavg_s", sigma=sigma, noniid=80.0)
        ada = _run(s, "adaptcl", sigma=sigma, noniid=80.0,
                   rate_cfg=PrunedRateConfig(rho_max=0.5, gamma_min=0.1))
        h = heterogeneity_closed_form(10, sigma)
        _row(
            f"table4/H{h:.2f}/speedup", f"{fed.total_time / ada.total_time:.2f}x",
            f"sigma={sigma};dacc={ada.best_acc - fed.best_acc:+.4f};"
            f"param_red={ada.param_reduction:.2%}",
        )


def fig2_principles(s: Settings):
    """Fig. 2 analogue: distributed-pruning principles, Non-IID(s=80).

    Fixed pruned rates (Tab. IX protocol) isolate the pruning criterion."""
    rates = [[0.4, 0.3, 0.3, 0.2, 0.2, 0.2, 0.1, 0.1, 0.1, 0.0]] * 2
    rows = {}
    for crit in ("cig_bnscalor", "index", "no_adjacent", "no_identical",
                 "no_constant", "l1", "taylor", "fpgm", "hrank"):
        r = _run(s, "adaptcl", noniid=80.0, importance=crit, fixed_pruned_rates=rates)
        sim_last = r.similarity_traj[-1][1] if r.similarity_traj else float("nan")
        rows[crit] = r
        _row(f"fig2/{crit}/acc", f"{r.best_acc:.4f}", f"similarity={sim_last:.3f}")
    # orderings the paper reports
    ok1 = rows["no_identical"].best_acc <= rows["index"].best_acc + 0.02
    ok2 = rows["cig_bnscalor"].best_acc >= rows["hrank"].best_acc - 0.02
    _row("fig2/identical_matters", ok1, "no_identical <= index (+tol)")
    _row("fig2/cig_beats_datadep", ok2, "cig >= hrank (-tol)")


def fig5_aggregation(s: Settings):
    """Fig. 5 analogue: By-worker vs By-unit, and pruning position beta."""
    rates = [[0.4, 0.3, 0.3, 0.2, 0.2, 0.2, 0.1, 0.1, 0.1, 0.0]]
    for agg in ("by_worker", "by_unit"):
        r = _run(s, "adaptcl", noniid=80.0, aggregation=agg, fixed_pruned_rates=rates)
        _row(f"fig5/{agg}/acc", f"{r.best_acc:.4f}", f"final={r.final_acc:.4f}")
    for beta in (0.0, 0.5, 1.0):
        r = _run(s, "adaptcl", noniid=80.0, beta=beta, fixed_pruned_rates=rates)
        _row(f"fig5/beta{beta}/acc", f"{r.best_acc:.4f}")


def fig8_convergence(s: Settings):
    """Fig. 8/9 analogue: update-time heterogeneity collapses within a few
    pruning intervals, for several starting heterogeneities."""
    for sigma in (2.0, 10.0):
        r = _run(s, "adaptcl", sigma=sigma)
        h0 = r.het_traj[0][1]
        h_end = np.mean([h for _, h in r.het_traj[-3:]])
        phis_last = r.update_times[-1]
        _row(
            f"fig8/sigma{sigma}/het", f"{h0:.3f}->{h_end:.3f}",
            f"spread_end={max(phis_last)/min(phis_last):.2f}x",
        )


def table14_interval(s: Settings):
    """Tab. XIV analogue: pruning interval PI sensitivity."""
    for pi in (2, s.pi):
        r = _run(s, "adaptcl", noniid=80.0, prune_interval=pi)
        _row(f"table14/PI{pi}/acc", f"{r.best_acc:.4f}", f"time_s={r.total_time:.1f}")


def table17_dgc(s: Settings):
    """Appendix E Tab. XVII: AdaptCL + DGC weight-delta compression."""
    for sparsity in (0.0, 0.7, 0.9):
        r = _run(s, "adaptcl", noniid=80.0, dgc_sparsity=sparsity)
        _row(f"table17/dgc{sparsity}/acc", f"{r.best_acc:.4f}",
             f"time_s={r.total_time:.1f};comm_GB={r.comm_bytes/1e9:.3f}")


def overhead(s: Settings):
    """§IV-B overhead claims: server compute, index communication, recompiles."""
    r = _run(s, "adaptcl")
    _row("overhead/server_s", f"{r.server_overhead_s:.3f}",
         f"wall_s={r.walltime_s:.1f};fraction_of_sim_time={r.server_overhead_s / max(r.total_time, 1e-9):.4f}")
    _row("overhead/recompiles", r.recompiles,
         f"jit (param-shape;shard;plan)-signatures compiled;engine={r.engine}")
    _row("overhead/comm_GB", f"{r.comm_bytes/1e9:.3f}", "payload incl. global-index ids")


def engines(s: Settings):
    """Fleet-engine host cost: same simulation, three local-training engines.

    The paper claim this backs is systemic, not statistical: heterogeneous
    sub-models need not serialize host training — masked batching runs the
    whole fleet as one stacked call per phase with no reconfigure rebuilds."""
    base = None
    for engine in ("sequential", "bucketed", "masked"):
        r = _run(s, "adaptcl", noniid=80.0, engine=engine)
        if base is None:
            base = r
        _row(
            f"engines/{engine}/walltime_s", f"{r.walltime_s:.2f}",
            f"recompiles={r.recompiles};batched_calls={r.batched_calls};"
            f"roundtrips={r.host_roundtrips};"
            f"speedup_vs_seq={base.walltime_s / max(r.walltime_s, 1e-9):.2f}x;"
            f"final_acc={r.final_acc:.4f}",
        )


# the reference's order; its tenth entry, roofline_table, is bench/run.py's
# (it reads the roofline sweep's records, not a simulation)
BENCHES = (
    ("table2_main", table2_main),
    ("table4_heterogeneity", table4_heterogeneity),
    ("fig2_principles", fig2_principles),
    ("fig5_aggregation", fig5_aggregation),
    ("fig8_convergence", fig8_convergence),
    ("table14_interval", table14_interval),
    ("table17_dgc", table17_dgc),
    ("overhead", overhead),
    ("engines", engines),
)
