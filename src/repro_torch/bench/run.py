"""Benchmark harness of the port: one function per paper table
(``name,value,derived`` CSV), and the scaling and retention sweeps.

    PYTHONPATH=src python -m repro_torch.bench.run [--only table2_main] [--quick]
    PYTHONPATH=src python -m repro_torch.bench.run scale [--quick] [--out BENCH_port_scale.json]
    PYTHONPATH=src python -m repro_torch.bench.run retention_sweep \\
        --cnn vgg16 --compute-blocks 128,128,128

Port of ``benchmarks/run.py``'s commands (``tables``, ``scale``,
``async_scale``, ``retention_sweep``, ``fused``, ``shard_scale``,
``regrow_sweep``, ``world_model``, ``robust_world``, ``flaky_grid``), with
the reference's rows, JSON keys and ``checks``.  A check that fails prints
``False``: it is bench data.  A failing bench is not: it raises, and the
process exits non-zero.  The ``roofline_table`` bench reads the TPU
dry-run's output; it is not ported and raises (ROADMAP.md).

Flags the reference does not have:

* ``--device {cuda,cpu}`` (default ``cuda``): where every run goes;
* ``--cnn {default,vgg16,resnet50}``: ``default`` is each command's own
  model, ``vgg16`` the paper's VGG16 (``VGG16_CIFAR``), ``resnet50``
  ``RESNET50_TINY``; the tasks follow the model's image size and classes;
* ``--compute-blocks BM,BN,BK`` for ``retention_sweep`` (default the
  reference's ``128,8,8``).  The CUDA kernel takes only multiples of 64, so
  on the card pass e.g. ``128,128,128``; the reference's blocks raise there.

``scale``: W x engine x scenario host-cost grid of the sync fleet
(``BENCH_port_scale.json``).  ``async_scale``: W x scheduler x participation
C x engine {masked, fused} (``BENCH_port_async.json``).  ``fused``: rounds/s
and host dispatches, masked vs fused (``BENCH_port_fused.json``).
``retention_sweep``: executed FLOPs and kernel blocks against retention,
dense vs block_skip (``BENCH_port_retention.json``).  ``shard_scale``: W x
mesh ranks over the fused sync engine (``BENCH_port_shard.json``); each mesh
cell is a ``torch.distributed`` job of one process per rank
(``launch.mesh.run_ranks``): gloo ranks on the CPU, up to 8 as the
reference's virtual devices, one NCCL rank per visible card on the card.
``regrow_sweep``: mask-readjustment variants x {masked, fused}
(``BENCH_port_regrow.json``).  ``world_model``: the fault worlds x {masked,
fused} (``BENCH_port_world.json``).  ``robust_world``: byzantine and
lossy-channel worlds against the robust server, with a one-rank mesh leg
(``BENCH_port_robust.json``).  ``flaky_grid``: the (C, dropout, churn) grid,
merged into ``BENCH_port_world.json`` under ``"flaky_grid"``.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.bench import tables
from repro_torch.core.aggregation import QuarantineConfig, RobustAggConfig
from repro_torch.core.faults import (
    ByzantineConfig,
    ChannelConfig,
    CrashConfig,
    DriftConfig,
    FaultConfig,
    OutageConfig,
    WaveConfig,
)
from repro_torch.core.scenario import ScenarioConfig
from repro_torch.core.simulation import RegrowConfig, SimConfig, resolve_device, run_simulation
from repro_torch.core.timing import HeterogeneityConfig
from repro_torch.data.synthetic import SyntheticImageTask
from repro_torch.launch import mesh as launch_mesh
from repro_torch.models.cnn import RESNET50_TINY, VGG16_CIFAR, CNNConfig, vgg_config

__all__ = ["scale", "async_scale", "fused", "retention_sweep", "shard_scale", "regrow_sweep",
           "world_model", "robust_world", "flaky_grid", "on_ranks", "main", "MODELS"]

MODELS = {"default": None, "vgg16": VGG16_CIFAR, "resnet50": RESNET50_TINY}
# ranks a CPU mesh may take: the reference's virtual XLA devices
CPU_RANKS = 8


def _dump(out_path: str, blob: dict) -> None:
    """Write a sweep's JSON, making its directory if need be."""
    pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(blob, f, indent=2)


def on_ranks(n: int, sim: SimConfig, device: str):
    """``run_simulation(sim)`` on an ``n``-rank fleet mesh (one spawned
    process per rank, ``launch.mesh.run_ranks``: NCCL on the card, gloo on
    the CPU); rank 0's ``SimResult``."""
    return launch_mesh.run_ranks(n, launch_mesh.simulate, (sim,), device=device)[0]


def scale(out_path: str = "BENCH_port_scale.json", quick: bool = False,
          device: str = "cuda", cnn: Optional[CNNConfig] = None) -> None:
    """Fleet-scaling bench: W x engine x scenario host-cost grid.

    The resident masked engine's host cost per round is ~flat in W (one
    stacked call + stacked aggregation), so W=200 stays within a small
    factor of W=10, while the sequential engine pays W calls and 2W
    extract/embed round-trips per round."""
    cnn = cnn or vgg_config("vgg_scale", [16, "M", 32], num_classes=10, image_size=8)
    worker_counts = (4, 12) if quick else (10, 50, 200)
    rounds = 2 if quick else 3
    scenarios = {
        "full": None,
        "flaky": ScenarioConfig(
            participation=0.5, dropout=0.1, churn=0.02, seed=1
        ),
    }
    rows = []
    print("name,value,derived")
    for W in worker_counts:
        for engine in ("sequential", "masked"):
            for scen_name, scen in scenarios.items():
                r = run_simulation(SimConfig(
                    method="adaptcl", engine=engine, scenario=scen,
                    rounds=rounds, prune_interval=2, num_workers=W,
                    batch_size=8, cnn=cnn, eval_every=rounds,
                    het=HeterogeneityConfig(num_workers=W, sigma=5.0),
                    seed=7, device=device,
                ))
                rows.append(dict(
                    workers=W, engine=engine, scenario=scen_name,
                    rounds=rounds, walltime_s=r.walltime_s,
                    recompiles=r.recompiles, batched_calls=r.batched_calls,
                    host_roundtrips=r.host_roundtrips,
                    final_acc=r.final_acc, total_time=r.total_time,
                ))
                print(
                    f"scale/W{W}/{engine}/{scen_name},{r.walltime_s:.2f}s,"
                    f"recompiles={r.recompiles};roundtrips={r.host_roundtrips};"
                    f"batched={r.batched_calls};acc={r.final_acc:.3f}"
                )
    by = {(row["workers"], row["engine"], row["scenario"]): row for row in rows}
    lo, hi = worker_counts[0], worker_counts[-1]
    for scen_name in scenarios:
        ratio = (by[(hi, "masked", scen_name)]["walltime_s"]
                 / max(by[(lo, "masked", scen_name)]["walltime_s"], 1e-9))
        print(f"scale/masked_W{hi}_over_W{lo}/{scen_name},{ratio:.2f}x,"
              f"resident host cost ~flat in W (target < 3x)")
    _dump(out_path, {"rows": rows, "worker_counts": list(worker_counts)})
    print(f"scale/json,{out_path},")


def async_scale(out_path: str = "BENCH_port_async.json", quick: bool = False,
                device: str = "cuda", cnn: Optional[CNNConfig] = None) -> None:
    """Async fleet-scaling bench: W x scheduler x participation C x engine.

    Every cell runs with window batching and no host round-trips; the
    resident masked engine makes one call per window batch, the fused
    engine (``core.fused``) runs chunks of window batches on the device.
    Rows split ``compile_walltime_s`` (the first call of each signature)
    from steady walltime; the largest-W full-cohort cells run interleaved
    masked/fused repetitions and the check takes the median of per-pair
    steady speedups.  At C < 1 device compute tracks the C*W participants
    instead of the slot pool."""
    cnn = cnn or vgg_config("vgg_ascale", [16, "M", 32], num_classes=10, image_size=8)
    worker_counts = (4, 12) if quick else (10, 50, 200)
    rounds = 2 if quick else 3
    parts = (1.0, 0.5) if quick else (1.0, 0.1)
    schedulers = ("fedasync_s", "ssp_s", "dcasgd_s")
    rows = []
    print("name,value,derived")

    def cell(engine, W, method, C):
        scen = None if C >= 1.0 else ScenarioConfig(participation=C, seed=1)
        n_part = W if C >= 1.0 else min(W, max(1, round(C * W)))
        r = run_simulation(SimConfig(
            method=method, engine=engine, scenario=scen,
            rounds=rounds, num_workers=W, batch_size=8, cnn=cnn,
            async_window=1000.0, eval_every=rounds,
            het=HeterogeneityConfig(num_workers=W, sigma=5.0),
            seed=7, device=device,
        ))
        if r.host_roundtrips != 0:
            raise RuntimeError(f"async_scale: resident {engine} {method} made "
                               f"{r.host_roundtrips} host round-trips")
        events = n_part * rounds
        steady = max(r.walltime_s - r.compile_walltime_s, 1e-9)
        row = dict(
            workers=W, engine=engine, scheduler=method, participation=C,
            rounds=rounds, events=events, walltime_s=r.walltime_s,
            compile_walltime_s=r.compile_walltime_s,
            steady_walltime_s=steady,
            events_per_sec_steady=events / steady,
            host_dispatches=r.host_dispatches, fused_chunks=r.fused_chunks,
            recompiles=r.recompiles, batched_calls=r.batched_calls,
            bucket_sizes=r.bucket_sizes,
            host_roundtrips=r.host_roundtrips,
            final_acc=r.final_acc, total_time=r.total_time,
        )
        rows.append(row)
        print(
            f"async_scale/W{W}/{engine}/{method}/C{C},"
            f"{events / steady:.2f}eps,"
            f"wall={r.walltime_s:.2f}s;compile={r.compile_walltime_s:.2f}s;"
            f"dispatches={r.host_dispatches};recompiles={r.recompiles};"
            f"acc={r.final_acc:.3f}"
        )
        return row

    hi = worker_counts[-1]
    pair_speedups = {m: [] for m in schedulers}
    for W in worker_counts:
        for method in schedulers:
            for C in parts:
                rm = cell("masked", W, method, C)
                rf = cell("fused", W, method, C)
                if W == hi and C == 1.0:
                    pair_speedups[method].append(
                        rm["steady_walltime_s"] / rf["steady_walltime_s"]
                    )
    for _ in range(0 if quick else 2):   # extra interleaved reps (see doc)
        for method in schedulers:
            rm = cell("masked", hi, method, 1.0)
            rf = cell("fused", hi, method, 1.0)
            pair_speedups[method].append(
                rm["steady_walltime_s"] / rf["steady_walltime_s"]
            )

    by = {}
    for row in rows:   # first occurrence wins (reps re-measure walltime only)
        key = (row["workers"], row["engine"], row["scheduler"],
               row["participation"])
        by.setdefault(key, row)
    lo = worker_counts[-2]
    c_lo = min(parts)
    ratios = {}
    for method in schedulers:
        ratio = (by[(hi, "masked", method, c_lo)]["steady_walltime_s"]
                 / max(by[(lo, "masked", method, c_lo)]["steady_walltime_s"],
                       1e-9))
        ratios[method] = ratio
        print(f"async_scale/{method}_W{hi}_over_W{lo}/C{c_lo},{ratio:.2f}x,"
              f"participation-sized compute (target ~<1.5x)")
    speedup = {
        m: sorted(s)[len(s) // 2] for m, s in pair_speedups.items()
    }
    checks = {
        # fused dispatches strictly fewer calls than resident in EVERY cell:
        # O(events/K) chunks + evals vs one call per window batch
        "fused_dispatches_strictly_below_resident": all(
            by[(W, "fused", m, C)]["host_dispatches"]
            < by[(W, "masked", m, C)]["host_dispatches"]
            for W in worker_counts for m in schedulers for C in parts
        ),
        "steady_speedup_at_max_W": speedup,
        "steady_speedup_samples": pair_speedups,
        "steady_speedup_ge_1_3x": all(s >= 1.3 for s in speedup.values()),
        "walltime_ratio_hi_over_lo_at_min_C": ratios,
    }
    for k, v in checks.items():
        print(f"async_scale/{k},{v},")
    _dump(out_path, {
        "rows": rows,
        "worker_counts": list(worker_counts),
        "participations": list(parts),
        "checks": checks,
    })
    print(f"async_scale/json,{out_path},")


def fused(out_path: str = "BENCH_port_fused.json", quick: bool = False,
          device: str = "cuda", cnn: Optional[CNNConfig] = None) -> None:
    """Round-fusion bench: W x engine {masked, fused} rounds/sec grid.

    The fused engine runs chunks of rounds between prune-rate-learning
    events on the device (``core.fused``), so host dispatches drop from
    O(rounds) to O(rounds / round_fusion).  Steady-state rounds/sec excludes
    the first call of each signature (``SimResult.compile_walltime_s``).
    Checks: at the largest W the fused engine does >= 3x the resident masked
    engine's steady rounds/sec, per-round prune indices are identical to the
    host path's (``prune_events``), and final accuracy matches the
    sequential engine within 1e-3 at the smallest W.  The cell keeps
    per-round device compute lean (tiny CNN, batch 8, one step per worker
    per round) so the round boundary dominates; the largest-W cell runs
    interleaved masked/fused repetitions and reports the median of the
    per-pair speedups."""
    cnn = cnn or vgg_config("vgg_fuse", [4, "M", 8], num_classes=10, image_size=8)
    worker_counts = (4, 12) if quick else (10, 50, 200)
    rounds = 4 if quick else 20
    fusion = 2 if quick else 5
    rows = []
    prune_identical = {}

    def cell(engine, W, n_rounds, pi, **kw):
        r = run_simulation(SimConfig(
            method="adaptcl", engine=engine, rounds=n_rounds,
            prune_interval=pi, num_workers=W, batch_size=8,
            cnn=cnn, eval_every=n_rounds,
            het=HeterogeneityConfig(num_workers=W, sigma=5.0),
            seed=7, device=device, **kw,
        ))
        steady = max(r.walltime_s - r.compile_walltime_s, 1e-9)
        rows.append(dict(
            workers=W, engine=engine, rounds=n_rounds,
            round_fusion=kw.get("round_fusion", 0),
            walltime_s=r.walltime_s,
            compile_walltime_s=r.compile_walltime_s,
            steady_walltime_s=steady,
            rounds_per_sec_steady=n_rounds / steady,
            host_dispatches=r.host_dispatches,
            host_roundtrips=r.host_roundtrips,
            fused_chunks=r.fused_chunks,
            recompiles=r.recompiles, final_acc=r.final_acc,
        ))
        print(
            f"fused/W{W}/{engine}/R{n_rounds},{n_rounds / steady:.2f}rps,"
            f"wall={r.walltime_s:.2f}s;compile={r.compile_walltime_s:.2f}s;"
            f"dispatches={r.host_dispatches};recompiles={r.recompiles};"
            f"acc={r.final_acc:.3f}"
        )
        return r

    print("name,value,derived")
    # equivalence cell against the sequential engine on a short run: long
    # runs accumulate cross-engine float drift past one test image
    eq_rounds = 3 if quick else 6
    r_seq = cell("sequential", worker_counts[0], eq_rounds, 2)
    r_feq = cell("fused", worker_counts[0], eq_rounds, 2, round_fusion=fusion)
    acc_gap_vs_sequential = abs(r_feq.final_acc - r_seq.final_acc)
    seq_prunes_identical = r_feq.prune_events == r_seq.prune_events

    hi = worker_counts[-1]
    pair_speedups = []
    for W in worker_counts:
        reps = (5 if W == hi else 1) if not quick else 1
        for _ in range(reps):
            r_m = cell("masked", W, rounds, fusion)
            r_f = cell("fused", W, rounds, fusion, round_fusion=fusion)
            prune_identical[W] = r_f.prune_events == r_m.prune_events
            if W == hi:
                pair_speedups.append(
                    (r_m.walltime_s - r_m.compile_walltime_s)
                    / max(r_f.walltime_s - r_f.compile_walltime_s, 1e-9)
                )
    by = {(row["workers"], row["engine"], row["rounds"]): row for row in rows}
    speedup = sorted(pair_speedups)[len(pair_speedups) // 2]
    dispatch_ratio = (by[(hi, "masked", rounds)]["host_dispatches"]
                      / max(by[(hi, "fused", rounds)]["host_dispatches"], 1))
    checks = {
        "prune_indices_bit_identical": (
            all(prune_identical.values()) and seq_prunes_identical
        ),
        "steady_speedup_at_max_W": speedup,
        "steady_speedup_samples": pair_speedups,
        "steady_speedup_ge_3x": speedup >= 3.0,
        "dispatch_ratio_at_max_W": dispatch_ratio,
        # 2 accuracy evals (initial + final) x 2 test batches are counted
        # dispatches on every engine; net of those, the fused round loop
        # dispatches one call per chunk
        "fused_dispatches_O_R_over_K": (
            by[(hi, "fused", rounds)]["host_dispatches"] - 4
            <= -(-rounds // fusion)
        ),
        "final_acc_gap_vs_sequential": acc_gap_vs_sequential,
        "final_acc_within_1e3_of_sequential": acc_gap_vs_sequential <= 1e-3,
    }
    for k, v in checks.items():
        print(f"fused/{k},{v},")
    _dump(out_path, {
        "rows": rows,
        "worker_counts": list(worker_counts),
        "round_fusion": fusion,
        "checks": checks,
    })
    print(f"fused/json,{out_path},")


def retention_sweep(out_path: str = "BENCH_port_retention.json", quick: bool = False,
                    device: str = "cuda", cnn: Optional[CNNConfig] = None,
                    compute_blocks: Tuple[int, int, int] = (128, 8, 8)) -> None:
    """Device-FLOPs-vs-retention bench: compute path x retention grid.

    The paper's speedup claim is that a worker at retention r does ~r of the
    FLOPs; the dense masked engine cannot show it (base-shape products,
    masks are multiplies), the ``block_skip`` path (the block-skip kernel on
    the card) must.  Each cell runs a resident adaptcl sim that prunes
    every worker to the target retention after round 1 (index-prefix
    importance: retained sets are coordinate prefixes), then trains at it;
    it records walltime, the executed/ideal FLOPs ratio and the kernel-grid
    block proxy.  Targets: blocks (and executed FLOPs) decrease
    monotonically with retention, and retention 0.25 executes < 0.5x the
    blocks of retention 1.0.  ``compute_blocks`` are the kernel's skip
    blocks, passed through unchanged."""
    cnn = cnn or vgg_config("vgg_ret", [32, "M", 64], num_classes=10, image_size=8)
    task = SyntheticImageTask(num_classes=cnn.num_classes, image_size=cnn.image_size,
                              train_size=64, test_size=64, seed=0)
    # rates realizing the target retentions under the index-prefix order
    targets = {1.0: 0.0, 0.5: 0.5, 0.25: 0.74, 0.125: 0.86}
    retentions = (1.0, 0.25) if quick else (1.0, 0.5, 0.25, 0.125)
    W, rounds = 2, 3
    rows = []
    print("name,value,derived")
    for compute in ("dense", "block_skip"):
        for target in retentions:
            r = run_simulation(SimConfig(
                method="adaptcl", engine="masked", compute=compute,
                compute_blocks=tuple(compute_blocks), importance="index",
                rounds=rounds, prune_interval=1, num_workers=W, batch_size=8,
                local_epochs=1.0, cnn=cnn, task=task, eval_every=rounds,
                fixed_pruned_rates=[[targets[target]] * W] + [[0.0] * W] * (rounds - 1),
                seed=3, device=device,
            ))
            rows.append(dict(
                compute=compute, retention_target=target,
                retention_realized=float(np.mean(r.retentions)),
                walltime_s=r.walltime_s,
                # first call of each signature vs steady state
                compile_walltime_s=r.compile_walltime_s,
                steady_walltime_s=r.walltime_s - r.compile_walltime_s,
                flops_executed=r.flops_executed, flops_ideal=r.flops_ideal,
                flops_ratio=r.flops_executed / max(r.flops_ideal, 1e-9),
                blocks_executed=r.blocks_executed,
                flops_per_image_final=r.flops_per_image_final,
                blocks_per_image_final=r.blocks_per_image_final,
                recompiles=r.recompiles, final_acc=r.final_acc,
            ))
            print(
                f"retention/{compute}/r{target},{r.walltime_s:.2f}s,"
                f"steady={rows[-1]['steady_walltime_s']:.2f}s;"
                f"compile={r.compile_walltime_s:.2f}s;"
                f"exec_over_ideal={rows[-1]['flops_ratio']:.3f};"
                f"blocks_final={r.blocks_per_image_final:.0f};acc={r.final_acc:.3f}"
            )
    # checks on the steady per-image cost of the final sub-models; rounds
    # before the prune land in the cumulative ledger instead
    by = {(row["compute"], row["retention_target"]): row for row in rows}
    checks = {}
    bs_rows = [by[("block_skip", t)] for t in retentions]
    checks["blocks_monotone_decreasing"] = all(
        a["blocks_per_image_final"] >= b["blocks_per_image_final"]
        for a, b in zip(bs_rows, bs_rows[1:])
    )
    checks["flops_monotone_decreasing"] = all(
        a["flops_per_image_final"] >= b["flops_per_image_final"]
        for a, b in zip(bs_rows, bs_rows[1:])
    )
    lo = by[("block_skip", 0.25 if 0.25 in retentions else min(retentions))]
    hi = by[("block_skip", 1.0)]
    checks["quarter_blocks_over_full"] = (
        lo["blocks_per_image_final"] / max(hi["blocks_per_image_final"], 1e-9)
    )
    checks["quarter_under_half_blocks"] = checks["quarter_blocks_over_full"] < 0.5
    checks["dense_flops_flat_in_retention"] = (
        by[("dense", min(retentions))]["flops_per_image_final"]
        == by[("dense", 1.0)]["flops_per_image_final"]
    )
    for k, v in checks.items():
        print(f"retention/{k},{v},")
    _dump(out_path, {"rows": rows, "retentions": list(retentions), "checks": checks})
    print(f"retention/json,{out_path},")


def shard_scale(out_path: str = "BENCH_port_shard.json", quick: bool = False,
                device: str = "cuda", cnn: Optional[CNNConfig] = None) -> None:
    """Mesh-sharded fleet bench: W x n_dev grid over the fused sync engine.

    Each rank holds ``W / n_dev`` rows of the resident stacks and runs the
    same fused chunk; aggregation is the two-tier collective, so host
    dispatches stay O(rounds / round_fusion) at every mesh size.  A mesh
    cell is an ``n_dev``-rank job (``on_ranks``); sizes the machine cannot
    give (more ranks than cards) print a ``skipped`` line.  Checks (the
    reference's): ``host_dispatches`` flat in n_dev, per-round prune indices
    identical at every mesh size, and steady rounds/sec at the largest W
    within 2.5x of the no-mesh engine (interleaved repetitions, median of
    per-pair ratios) — bench data, printed whether it holds or not."""
    # one rank a visible card, or CPU_RANKS gloo processes on the CPU
    dev = resolve_device(device, "--device")
    n_avail = torch.cuda.device_count() if dev.type == "cuda" else CPU_RANKS
    cnn = cnn or vgg_config("vgg_shard", [4, "M", 8], num_classes=10, image_size=8)
    worker_counts = (8,) if quick else (8, 64, 256)
    device_counts = tuple(d for d in (1, 2, 4, 8) if d <= n_avail)
    rounds = 4 if quick else 16
    fusion = 2 if quick else 4
    rows = []
    print("name,value,derived")
    for d in (1, 2, 4, 8):
        if d > n_avail:
            print(f"shard_scale/skipped,needs >= {d} devices "
                  f"(one rank per card; {n_avail} visible),")

    def cell(W, n_dev):
        sim = SimConfig(
            method="adaptcl", engine="fused", rounds=rounds,
            prune_interval=fusion, round_fusion=fusion, num_workers=W,
            batch_size=8, cnn=cnn, eval_every=rounds,
            het=HeterogeneityConfig(num_workers=W, sigma=5.0),
            seed=7, device=device,
        )
        r = run_simulation(sim) if n_dev == 0 else on_ranks(n_dev, sim, device)
        if r.host_roundtrips != 0:
            raise RuntimeError(f"shard_scale: W={W} n_dev={n_dev} made "
                               f"{r.host_roundtrips} host round-trips")
        steady = max(r.walltime_s - r.compile_walltime_s, 1e-9)
        rows.append(dict(
            workers=W, n_dev=r.n_devices if n_dev else 0,
            shard_spec=r.shard_spec, rounds=rounds, round_fusion=fusion,
            walltime_s=r.walltime_s,
            compile_walltime_s=r.compile_walltime_s,
            steady_walltime_s=steady,
            rounds_per_sec_steady=rounds / steady,
            host_dispatches=r.host_dispatches,
            fused_chunks=r.fused_chunks, recompiles=r.recompiles,
            final_acc=r.final_acc,
        ))
        print(
            f"shard_scale/W{W}/ndev{n_dev},{rounds / steady:.2f}rps,"
            f"wall={r.walltime_s:.2f}s;compile={r.compile_walltime_s:.2f}s;"
            f"dispatches={r.host_dispatches};spec={r.shard_spec};"
            f"acc={r.final_acc:.3f}"
        )
        return r

    hi = worker_counts[-1]
    prune_identical, dispatches_flat = [], []
    pair_ratios = []
    for W in worker_counts:
        base = cell(W, 0)   # the no-mesh fused baseline
        for n_dev in device_counts:
            if W % n_dev:
                continue
            r = cell(W, n_dev)
            prune_identical.append(r.prune_events == base.prune_events)
            dispatches_flat.append(r.host_dispatches == base.host_dispatches)
    n_max = max(d for d in device_counts if hi % d == 0)
    for _ in range(1 if quick else 3):   # interleaved reps at the largest W
        r_b = cell(hi, 0)
        r_s = cell(hi, n_max)
        pair_ratios.append(
            (r_b.walltime_s - r_b.compile_walltime_s)
            / max(r_s.walltime_s - r_s.compile_walltime_s, 1e-9)
        )
    ratio = sorted(pair_ratios)[len(pair_ratios) // 2]
    checks = {
        "host_dispatches_flat_in_n_dev": all(dispatches_flat),
        "prune_indices_bit_identical": all(prune_identical),
        "steady_ratio_at_max_W": ratio,           # no-mesh steady / mesh steady
        "steady_ratio_samples": pair_ratios,
        "steady_within_2_5x_of_single_device": ratio >= 0.4,
    }
    for k, v in checks.items():
        print(f"shard_scale/{k},{v},")
    _dump(out_path, {
        "rows": rows,
        "worker_counts": list(worker_counts),
        "device_counts": list(device_counts),
        "round_fusion": fusion,
        "checks": checks,
    })
    print(f"shard_scale/json,{out_path},")


def regrow_sweep(out_path: str = "BENCH_port_regrow.json", quick: bool = False,
                 device: str = "cuda", cnn: Optional[CNNConfig] = None) -> None:
    """Mask-regrowth bench: mask-dynamics variant x engine grid.

    Prune-only against FedDST readjustment (``SimConfig.regrow``, cosine and
    constant ``alpha_t``) on the masked and fused engines, pruning in the
    ``no_adjacent`` shared-random order (a poor initial mask, which
    readjustment can repair).  Checks (the reference's): the best regrow
    variant recovers at least the prune-only final accuracy, regrow events
    land in ``prune_events`` with masked == fused events and clocks, and
    the fused engine runs R / K chunks with dispatches = chunks + evals +
    one grow gradient per regrow event and recompiles <= 2."""
    cnn = cnn or vgg_config("vgg_regrow", [16, "M", 32], num_classes=10, image_size=8)
    W = 5 if quick else 10
    rounds = 6 if quick else 16
    pi = 2 if quick else 4      # prune_interval == round_fusion == interval
    variants = {
        "prune_only": None,
        "regrow_cosine": RegrowConfig(interval=pi, alpha0=0.3, schedule="cosine"),
        "regrow_constant": RegrowConfig(interval=pi, alpha0=0.3, schedule="constant"),
    }
    rows = []
    results = {}
    print("name,value,derived")
    for vname, rg in variants.items():
        for engine in ("masked", "fused"):
            r = run_simulation(SimConfig(
                method="adaptcl", engine=engine, rounds=rounds,
                prune_interval=pi, round_fusion=pi, num_workers=W,
                batch_size=8, cnn=cnn, eval_every=rounds,
                het=HeterogeneityConfig(num_workers=W, sigma=5.0),
                seed=7, regrow=rg, importance="no_adjacent", device=device,
            ))
            results[(vname, engine)] = r
            event_rounds = sorted({t for t, _, _ in r.prune_events})
            rows.append(dict(
                variant=vname, engine=engine, rounds=rounds,
                round_fusion=pi, workers=W,
                final_acc=r.final_acc, total_time=r.total_time,
                comm_bytes=r.comm_bytes,
                prune_event_count=len(r.prune_events),
                prune_event_rounds=event_rounds,
                host_dispatches=r.host_dispatches,
                fused_chunks=r.fused_chunks, recompiles=r.recompiles,
                walltime_s=r.walltime_s,
                compile_walltime_s=r.compile_walltime_s,
            ))
            print(
                f"regrow/{vname}/{engine},acc={r.final_acc:.3f},"
                f"time={r.total_time:.1f};events={len(r.prune_events)};"
                f"dispatches={r.host_dispatches};recompiles={r.recompiles}"
            )

    prune_only_acc = results[("prune_only", "fused")].final_acc
    best_regrow_acc = max(
        results[(v, "fused")].final_acc for v in ("regrow_cosine", "regrow_constant")
    )
    fus = results[("regrow_cosine", "fused")]
    mas = results[("regrow_cosine", "masked")]
    base_f = results[("prune_only", "fused")]
    checks = {
        "best_regrow_acc": best_regrow_acc,
        "prune_only_acc": prune_only_acc,
        "regrow_acc_ge_prune_only": best_regrow_acc >= prune_only_acc,
        "regrow_adds_events": all(
            len(results[(v, e)].prune_events) > len(results[("prune_only", e)].prune_events)
            for v in ("regrow_cosine", "regrow_constant") for e in ("masked", "fused")
        ),
        "events_bit_identical_masked_vs_fused": all(
            results[(v, "masked")].prune_events == results[(v, "fused")].prune_events
            for v in variants
        ),
        "clocks_identical_masked_vs_fused": all(
            results[(v, "masked")].total_time == results[(v, "fused")].total_time
            for v in variants
        ),
        "fused_chunks_O_R_over_K": fus.fused_chunks == rounds // pi,
        "fused_dispatches_are_chunks_evals_and_grow_grads": (
            fus.host_dispatches - fus.fused_chunks
            - (len(fus.prune_events) - len(base_f.prune_events))
            == base_f.host_dispatches - base_f.fused_chunks
        ),
        "fused_regrow_recompiles_le_2": fus.recompiles <= 2,
        "fused_dispatches_below_masked": fus.host_dispatches < mas.host_dispatches,
    }
    for k, v in checks.items():
        print(f"regrow/{k},{v},")
    _dump(out_path, {"rows": rows, "rounds": rounds, "round_fusion": pi, "checks": checks})
    print(f"regrow/json,{out_path},")


def world_model(out_path: str = "BENCH_port_world.json", quick: bool = False,
                device: str = "cuda", cnn: Optional[CNNConfig] = None) -> None:
    """Fault-injection world-model bench: accuracy vs flakiness x engine.

    The scripted fault families (drift, crash/recovery, a regional outage, a
    participation wave, all four combined) on the masked and fused engines.
    Checks (the reference's): an all-inactive ``FaultConfig()`` is
    bit-identical to ``faults=None``; masked == fused in clocks, prune
    events and fault ledgers with accuracy within 0.02; crash/outage/wave
    ride in the chunks (R / K of them), drift cuts at most its own extras;
    recompiles <= 2; no fault world beats the fault-free run beyond 0.08,
    every world converges past chance, and each family leaves its ledger
    signature."""
    cnn = cnn or vgg_config("vgg_world", [16, "M", 32], num_classes=10, image_size=8)
    W = 5 if quick else 10
    rounds = 6 if quick else 16
    pi = 2 if quick else 4      # prune_interval == round_fusion
    drift_round = pi + 1        # mid-interval: re-learning is drift-triggered
    dark = W // 2               # regional outage: slots [0, dark) go dark
    worlds = {
        "fault_free": dict(seed=3),
        "drift": dict(seed=3, faults=FaultConfig(
            drift=DriftConfig(worker=1, round=drift_round, factor=3.0))),
        "crash": dict(seed=3, faults=FaultConfig(
            crash=CrashConfig(rate=0.15, outage_rounds=2, recovery_rounds=1))),
        "outage": dict(seed=3, min_participants=W - dark + 1,
                       faults=FaultConfig(outage=OutageConfig(
                           start=pi + 1, length=2, slot_lo=0, slot_hi=dark))),
        "wave": dict(seed=3, participation=0.8, faults=FaultConfig(
            wave=WaveConfig(amplitude=0.5, period=max(2, rounds // 2)))),
        "combined": dict(seed=3, min_participants=2, participation=0.9,
                         faults=FaultConfig(
                             drift=DriftConfig(worker=0, round=drift_round, factor=2.0,
                                               mode="ramp", ramp_rounds=3),
                             crash=CrashConfig(rate=0.1),
                             outage=OutageConfig(start=rounds - 2, length=2, slot_lo=0,
                                                 slot_hi=dark),
                             wave=WaveConfig(amplitude=0.4, period=max(2, rounds // 2)))),
    }
    ledger_fields = ("drift_events", "rounds_degraded", "rounds_skipped",
                     "workers_recovered", "retry_total")

    def run(engine, scen_kw):
        return run_simulation(SimConfig(
            method="adaptcl", engine=engine, rounds=rounds,
            prune_interval=pi, round_fusion=pi, num_workers=W,
            batch_size=8, cnn=cnn, eval_every=rounds,
            het=HeterogeneityConfig(num_workers=W, sigma=5.0),
            seed=7, scenario=ScenarioConfig(**scen_kw), device=device,
        ))

    rows = []
    results = {}
    print("name,value,derived")
    for wname, scen_kw in worlds.items():
        for engine in ("masked", "fused"):
            r = run(engine, scen_kw)
            results[(wname, engine)] = r
            led = {f: getattr(r, f) for f in ledger_fields}
            rows.append(dict(
                world=wname, engine=engine, rounds=rounds, round_fusion=pi,
                workers=W, final_acc=r.final_acc, total_time=r.total_time,
                comm_bytes=r.comm_bytes,
                prune_event_count=len(r.prune_events),
                host_dispatches=r.host_dispatches,
                fused_chunks=r.fused_chunks, recompiles=r.recompiles,
                walltime_s=r.walltime_s,
                compile_walltime_s=r.compile_walltime_s,
                **led,
            ))
            print(
                f"world/{wname}/{engine},acc={r.final_acc:.3f},"
                f"time={r.total_time:.1f};skipped={r.rounds_skipped};"
                f"degraded={r.rounds_degraded};recovered={r.workers_recovered};"
                f"dispatches={r.host_dispatches};recompiles={r.recompiles}"
            )

    # the regression leg: an all-inactive FaultConfig must be invisible
    inert = run("fused", dict(seed=3, faults=FaultConfig()))
    free = results[("fault_free", "fused")]
    acc_free = free.final_acc
    acc_slack = 0.08            # eval noise band on this tiny fixture
    checks = {
        "faultfree_bit_identical": (
            inert.final_acc == acc_free
            and inert.total_time == free.total_time
            and inert.prune_events == free.prune_events
        ),
        "engines_equivalent": all(_engines_equivalent(results, wn, ledger_fields)
                                  for wn in worlds),
        "fused_chunks_O_R_over_K": all(
            results[(wn, "fused")].fused_chunks == rounds // pi
            for wn in ("fault_free", "crash", "outage", "wave")
        ),
        "drift_cuts_bounded": (
            results[("drift", "fused")].fused_chunks <= rounds // pi + 1
            and results[("combined", "fused")].fused_chunks <= rounds // pi + 3
        ),
        "fused_recompiles_le_2": all(results[(wn, "fused")].recompiles <= 2 for wn in worlds),
        "acc_flakiness_guard": all(
            results[(wn, "fused")].final_acc <= acc_free + acc_slack for wn in worlds
        ),
        "faulty_worlds_still_converge": all(
            results[(wn, "fused")].final_acc >= 2.0 / cnn.num_classes for wn in worlds
        ),
        "drift_triggered_relearning": results[("drift", "fused")].drift_events >= 1,
        "crash_recovered_workers": results[("crash", "fused")].workers_recovered >= 1,
        "outage_skipped_not_hung": (
            results[("outage", "fused")].rounds_skipped >= 1
            and len(results[("outage", "fused")].scenario_rounds) == rounds
        ),
        "wave_varies_cohort": len({
            n for _, n, _, _ in results[("wave", "fused")].scenario_rounds
        }) > 1,
        "faultfree_ledger_zero": all(getattr(free, f) == 0 for f in ledger_fields),
    }
    for k, v in checks.items():
        print(f"world/{k},{v},")
    _dump(out_path, {"rows": rows, "rounds": rounds, "round_fusion": pi, "checks": checks})
    print(f"world/json,{out_path},")


def _engines_equivalent(results, key, ledger_fields=()) -> bool:
    """The reference's masked == fused check of one cell: clocks and prune
    events exact, final accuracy within 0.02, equal ledger fields."""
    if not isinstance(key, tuple):
        key = (key,)
    m, f = results[key + ("masked",)], results[key + ("fused",)]
    return (m.total_time == f.total_time and m.prune_events == f.prune_events
            and abs(m.final_acc - f.final_acc) <= 0.02
            and all(getattr(m, x) == getattr(f, x) for x in ledger_fields))


def robust_world(out_path: str = "BENCH_port_robust.json", quick: bool = False,
                 device: str = "cuda", cnn: Optional[CNNConfig] = None) -> None:
    """Robust-aggregation bench: byzantine and lossy-channel worlds x defense.

    A fixed 20 % byzantine cohort sending ``-10 x delta`` and a lossy
    channel (drop / duplicate / corrupt) against the robust server (clip 1,
    trimmed mean 0.2, quarantine with a probation that outlasts the run),
    on the masked and fused engines.  Checks (the reference's): the plain
    mean collapses and the robust server recovers (>= mean + 10 points,
    within 5 of fault-free; the channel within 10); masked == fused in
    clocks, events and the whole ledger; R / K chunks, recompiles <= 2;
    each family leaves its ledger signature; and the mesh leg: the robust
    byzantine world on a one-rank fleet mesh (a one-rank ``torch.distributed``
    job, ``on_ranks``) is bit-identical to the no-mesh fused run."""
    cnn = cnn or vgg_config("vgg_robust", [16, "M", 32], num_classes=10, image_size=8)
    W = 5 if quick else 10
    rounds = 6 if quick else 16
    pi = 2 if quick else 4      # prune_interval == round_fusion
    byz_workers = tuple(range(max(1, W // 5)))   # fixed 20% compromised set
    byz = FaultConfig(byzantine=ByzantineConfig(workers=byz_workers, mode="scale", scale=-10.0))
    chan = FaultConfig(channel=ChannelConfig(drop=0.15, dup=0.15, corrupt=0.1,
                                             corrupt_std=10.0))
    defense = RobustAggConfig(clip=1.0, trim=0.2, quarantine=QuarantineConfig(probation=100))
    worlds = {
        "fault_free": (None, None),
        "byz_mean": (byz, None),
        "byz_robust": (byz, defense),
        "channel_mean": (chan, None),
        "channel_robust": (chan, defense),
    }
    ledger_fields = ("drift_events", "rounds_degraded", "rounds_skipped",
                     "workers_recovered", "retry_total", "byz_commits",
                     "lost_commits", "dup_commits", "corrupt_commits",
                     "quarantined_commits")

    def sim(engine, faults, robust):
        return SimConfig(
            method="adaptcl", engine=engine, rounds=rounds,
            prune_interval=pi, round_fusion=pi, num_workers=W,
            batch_size=8, cnn=cnn, eval_every=rounds,
            het=HeterogeneityConfig(num_workers=W, sigma=5.0),
            seed=7, robust=robust,
            scenario=ScenarioConfig(seed=3, faults=faults), device=device,
        )

    rows = []
    results = {}
    print("name,value,derived")
    for wname, (faults, robust) in worlds.items():
        for engine in ("masked", "fused"):
            r = run_simulation(sim(engine, faults, robust))
            results[(wname, engine)] = r
            led = {f: getattr(r, f) for f in ledger_fields}
            rows.append(dict(
                world=wname, engine=engine, rounds=rounds, round_fusion=pi,
                workers=W, byz_workers=list(byz_workers),
                final_acc=r.final_acc, total_time=r.total_time,
                comm_bytes=r.comm_bytes,
                prune_event_count=len(r.prune_events),
                host_dispatches=r.host_dispatches,
                fused_chunks=r.fused_chunks, recompiles=r.recompiles,
                walltime_s=r.walltime_s,
                compile_walltime_s=r.compile_walltime_s,
                **led,
            ))
            print(
                f"robust/{wname}/{engine},acc={r.final_acc:.3f},"
                f"time={r.total_time:.1f};byz={r.byz_commits};"
                f"lost={r.lost_commits};dup={r.dup_commits};"
                f"corrupt={r.corrupt_commits};quar={r.quarantined_commits};"
                f"retries={r.retry_total};dispatches={r.host_dispatches};"
                f"recompiles={r.recompiles}"
            )

    # the mesh leg: a one-rank mesh == no mesh, bit for bit
    mesh_r = on_ranks(1, sim("fused", byz, defense), device)
    base_r = results[("byz_robust", "fused")]
    mesh_identical = (
        all(np.array_equal(base_r.global_params[k], mesh_r.global_params[k])
            for k in base_r.global_params)
        and mesh_r.prune_events == base_r.prune_events
        and mesh_r.total_time == base_r.total_time
        and all(getattr(mesh_r, f) == getattr(base_r, f) for f in ledger_fields)
    )

    free = results[("fault_free", "fused")].final_acc
    mean_acc = results[("byz_mean", "fused")].final_acc
    rob_acc = results[("byz_robust", "fused")].final_acc
    chan_r = results[("channel_robust", "fused")]
    checks = {
        "byz_mean_acc": mean_acc,
        "byz_robust_acc": rob_acc,
        "fault_free_acc": free,
        "robust_ge_mean_plus_10pts": rob_acc >= mean_acc + 0.10,
        "robust_within_5pts_of_fault_free": rob_acc >= free - 0.05,
        "channel_robust_ge_mean_plus_10pts": (
            chan_r.final_acc >= results[("channel_mean", "fused")].final_acc + 0.10
        ),
        "channel_robust_within_10pts_of_fault_free": chan_r.final_acc >= free - 0.10,
        "engines_equivalent": all(_engines_equivalent(results, wn, ledger_fields)
                                  for wn in worlds),
        "fused_chunks_O_R_over_K": all(
            results[(wn, "fused")].fused_chunks == rounds // pi for wn in worlds
        ),
        "fused_recompiles_le_2": all(results[(wn, "fused")].recompiles <= 2 for wn in worlds),
        "mesh_1dev_bit_identical": mesh_identical,
        "byz_commits_counted": results[("byz_mean", "fused")].byz_commits > 0,
        "channel_ledger_active": (
            chan_r.retry_total > 0 and chan_r.dup_commits > 0 and chan_r.corrupt_commits > 0
        ),
        "quarantine_fired": results[("byz_robust", "fused")].quarantined_commits > 0,
        "faultfree_ledger_zero": all(
            getattr(results[("fault_free", "fused")], f) == 0 for f in ledger_fields
        ),
    }
    for k, v in checks.items():
        print(f"robust/{k},{v},")
    _dump(out_path, {"rows": rows, "rounds": rounds, "round_fusion": pi,
                     "byz_workers": list(byz_workers), "checks": checks})
    print(f"robust/json,{out_path},")


def flaky_grid(out_path: str = "BENCH_port_world.json", quick: bool = False,
               device: str = "cuda", cnn: Optional[CNNConfig] = None) -> None:
    """Flakiness grid: (participation C, dropout, churn) x engine sweep,
    merged into ``out_path`` (beside the fault worlds) under ``flaky_grid``.
    Checks (the reference's): masked == fused in every cell (clocks and
    prune events exact, accuracy within 0.02), the clean cell equals the
    scenario-free run, every cell converges past chance, no flaky cell
    beats the clean one beyond 0.08, recompiles <= 2."""
    cnn = cnn or vgg_config("vgg_flaky", [16, "M", 32], num_classes=10, image_size=8)
    W = 5 if quick else 10
    rounds = 6 if quick else 16
    pi = 2 if quick else 4
    parts = (1.0, 0.5)
    dropouts = (0.0, 0.2)
    churns = (0.0,) if quick else (0.0, 0.05)

    def run(engine, scen):
        return run_simulation(SimConfig(
            method="adaptcl", engine=engine, rounds=rounds,
            prune_interval=pi, round_fusion=pi, num_workers=W,
            batch_size=8, cnn=cnn, eval_every=rounds,
            het=HeterogeneityConfig(num_workers=W, sigma=5.0),
            seed=7, scenario=scen, device=device,
        ))

    rows = []
    results = {}
    print("name,value,derived")
    base = run("fused", None)
    for C in parts:
        for drop in dropouts:
            for churn in churns:
                scen = ScenarioConfig(participation=C, dropout=drop, churn=churn, seed=3)
                for engine in ("masked", "fused"):
                    r = run(engine, scen)
                    results[(C, drop, churn, engine)] = r
                    rows.append(dict(
                        participation=C, dropout=drop, churn=churn,
                        engine=engine, rounds=rounds, workers=W,
                        final_acc=r.final_acc, total_time=r.total_time,
                        rounds_skipped=r.rounds_skipped,
                        host_dispatches=r.host_dispatches,
                        fused_chunks=r.fused_chunks,
                        recompiles=r.recompiles,
                    ))
                    print(
                        f"flaky/C{C}/d{drop}/ch{churn}/{engine},"
                        f"acc={r.final_acc:.3f},"
                        f"time={r.total_time:.1f};"
                        f"dispatches={r.host_dispatches};"
                        f"recompiles={r.recompiles}"
                    )

    cells = [(C, d, ch) for C in parts for d in dropouts for ch in churns]
    clean = results[(1.0, 0.0, 0.0, "fused")]
    acc_slack = 0.08            # eval noise band on this fixture
    checks = {
        "engines_equivalent": all(_engines_equivalent(results, c) for c in cells),
        "clean_cell_matches_no_scenario": (
            clean.final_acc == base.final_acc
            and clean.total_time == base.total_time
            and clean.prune_events == base.prune_events
        ),
        "all_cells_converge": all(
            results[c + ("fused",)].final_acc >= 2.0 / cnn.num_classes for c in cells
        ),
        "acc_flakiness_guard": all(
            results[c + ("fused",)].final_acc <= clean.final_acc + acc_slack for c in cells
        ),
        "fused_recompiles_le_2": all(results[c + ("fused",)].recompiles <= 2 for c in cells),
    }
    for k, v in checks.items():
        print(f"flaky/{k},{v},")
    blob = {}
    if os.path.exists(out_path):
        try:
            with open(out_path) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            blob = {}
    blob["flaky_grid"] = {
        "rows": rows, "rounds": rounds,
        "participations": list(parts), "dropouts": list(dropouts),
        "churns": list(churns), "checks": checks,
    }
    _dump(out_path, blob)
    print(f"flaky/json,{out_path},")


def _blocks(text: str) -> Tuple[int, int, int]:
    vals = tuple(int(v) for v in text.split(","))
    if len(vals) != 3:
        raise argparse.ArgumentTypeError(f"--compute-blocks takes BM,BN,BK, got {text!r}")
    return vals


# command -> (sweep, stem of its default output BENCH_port_<stem>.json)
SWEEPS = {"scale": (scale, "scale"), "async_scale": (async_scale, "async"),
          "retention_sweep": (retention_sweep, "retention"), "fused": (fused, "fused"),
          "shard_scale": (shard_scale, "shard"), "regrow_sweep": (regrow_sweep, "regrow"),
          "world_model": (world_model, "world"), "robust_world": (robust_world, "robust"),
          "flaky_grid": (flaky_grid, "world")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument(
        "command", nargs="?", default="tables",
        choices=("tables",) + tuple(SWEEPS),
        help="'tables' (default) = paper-table benches; 'scale' = sync "
             "fleet-scaling grid; 'async_scale' = resident async scheduler "
             "grid; 'retention_sweep' = device FLOPs vs retention, dense vs "
             "block_skip; 'fused' = round-fusion rounds/sec + host-dispatch "
             "grid, masked vs fused; 'shard_scale' = W x mesh ranks over the "
             "fused engine; 'regrow_sweep' = mask-readjustment variants x "
             "engine; 'world_model' = fault worlds x engine; 'robust_world' = "
             "byzantine / lossy-channel worlds vs the robust server; "
             "'flaky_grid' = (C, dropout, churn) grid merged into "
             "BENCH_port_world.json",
    )
    ap.add_argument("--only", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None,
                    help="output JSON of a sweep (default BENCH_port_<sweep>.json)")
    ap.add_argument(
        "--engine", default="sequential",
        choices=("sequential", "bucketed", "masked"),
        help="fleet engine for the tables' local training (core.fleet)",
    )
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cnn", default="default", choices=tuple(MODELS),
                    help="model: each command's own (default), VGG16_CIFAR or RESNET50_TINY")
    ap.add_argument("--compute-blocks", type=_blocks, default=(128, 8, 8), metavar="BM,BN,BK",
                    help="retention_sweep's kernel skip blocks (multiples of 64 on the card)")
    args = ap.parse_args(argv)
    cnn = MODELS[args.cnn]

    if args.command in SWEEPS:
        fn, out = SWEEPS[args.command]
        kw = dict(quick=args.quick, device=args.device, cnn=cnn)
        if args.command == "retention_sweep":
            kw["compute_blocks"] = args.compute_blocks
        fn(args.out or f"BENCH_port_{out}.json", **kw)
        return 0

    names = [name for name, _ in tables.BENCHES]
    if args.only == "roofline_table":
        raise ValueError("roofline_table reads the TPU dry-run's output and is not ported "
                         "to repro_torch (see ROADMAP.md, queue A6)")
    if args.only is not None and args.only not in names:
        raise ValueError(f"--only {args.only!r}: choose from {names}")
    # as in the reference, BENCH_QUICK=1 in the environment also shrinks the tables
    quick = args.quick or os.environ.get("BENCH_QUICK", "") == "1"
    settings = tables.Settings(quick=quick, engine=args.engine, device=args.device, cnn=cnn)
    print("name,value,derived")
    for name, fn in tables.BENCHES:
        if args.only and name != args.only:
            continue
        t0 = time.perf_counter()
        fn(settings)
        print(f"{name}/_elapsed_s,{time.perf_counter() - t0:.1f},")
    return 0


if __name__ == "__main__":
    sys.exit(main())
