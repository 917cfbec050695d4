"""End-to-end script on the port: the AdaptCL reproduction (paper Alg. 1+2)
in PyTorch, on the card by default.

Port of ``examples/adaptcl_sim.py``, with its flags and print lines: 10
heterogeneous workers, synchronous rounds, dynamic pruned-rate learning,
CIG-BNscalor pruning and by-worker aggregation against the FedAVG-S
baseline, printed as a Table II-style comparison.

    PYTHONPATH=src python examples/torch_adaptcl_sim.py [--rounds 30] [--sigma 2] \\
        [--workers 10] [--engine masked] [--scenario 0.5,0.1,0.02] [--device cpu]

``--engine masked`` runs the resident fleet engine (``core.fleet``): all
workers live as [W, ...] base-shape stacks on the device.
``--compute block_skip`` (with ``--engine masked``) runs the convs and the
head through the block-skip kernel, so a pruned worker's device FLOPs
track its retention; ``--compute-blocks`` sets the skip blocks (multiples
of 64 on the card).  ``--cnn vgg16`` trains the paper's VGG16
(``VGG16_CIFAR``), ``--cnn resnet50`` ``RESNET50_TINY``.

``--mesh-devices N`` (with ``--engine fused``, sync methods) shards the
resident stacks over N ranks of a ``torch.distributed`` group, started by
``repro_torch.launch.mesh.spawn_ranks`` (gloo on the CPU, NCCL on cards);
rank 0's result is printed.

``--methods`` picks the frameworks to compare (first = baseline for the
speedup line), e.g. the async schedulers on the resident engine:

    PYTHONPATH=src python examples/torch_adaptcl_sim.py --engine masked \\
        --methods fedasync_s,ssp_s,dcasgd_s --async-window 50 --rounds 6
"""
import argparse

from repro_torch.bench.run import MODELS
from repro_torch.core.scenario import ScenarioConfig
from repro_torch.core.simulation import SimConfig, run_simulation
from repro_torch.core.timing import HeterogeneityConfig
from repro_torch.launch.mesh import run_ranks, simulate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--sigma", type=float, default=2.0)
    ap.add_argument("--noniid", type=float, default=80.0)
    ap.add_argument("--workers", type=int, default=10)
    ap.add_argument("--engine", default="sequential",
                    choices=("sequential", "bucketed", "masked", "fused"))
    ap.add_argument("--round-fusion", type=int, default=0,
                    help="fused engine: max rounds per device chunk (0 = fuse "
                         "up to the next prune-rate-learning event)")
    ap.add_argument("--compute", default="dense",
                    choices=("dense", "block_skip"),
                    help="masked engine's device compute path: block_skip "
                         "runs convs + head through the block-skip kernel so "
                         "device FLOPs track retention (requires --engine masked)")
    ap.add_argument("--compute-blocks", default="128,128,128",
                    metavar="BM,BN,BK",
                    help="pruned_matmul skip blocks; multiples of 64 on the card")
    ap.add_argument("--mesh-devices", type=int, default=0, metavar="N",
                    help="mesh-sharded fleet: shard the [W, ...] stacks over "
                         "N ranks (fused sync engine only; W %% N == 0)")
    ap.add_argument("--scenario", default=None, metavar="C,DROPOUT,CHURN",
                    help="client sampling fraction, dropout prob, churn prob")
    ap.add_argument("--methods", default="fedavg_s,adaptcl",
                    help="comma list of frameworks to compare (first = "
                         "baseline): fedavg, fedavg_s, adaptcl, fedasync_s, "
                         "ssp_s, dcasgd_s")
    ap.add_argument("--async-window", type=float, default=0.0,
                    help="virtual window batching async commits into one "
                         "fleet call (async methods only)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cnn", default="default", choices=tuple(MODELS),
                    help="model: the simulator's default small VGG, "
                         "VGG16_CIFAR or RESNET50_TINY")
    args = ap.parse_args()

    scenario = None
    if args.scenario:
        c, drop, churn = (float(v) for v in args.scenario.split(","))
        scenario = ScenarioConfig(participation=c, dropout=drop, churn=churn)
    model = {} if MODELS[args.cnn] is None else {"cnn": MODELS[args.cnn]}

    methods = [m.strip() for m in args.methods.split(",") if m.strip()]
    results = {}
    for method in methods:
        sim = SimConfig(
            method=method,
            rounds=args.rounds,
            prune_interval=5,
            num_workers=args.workers,
            noniid_s=args.noniid,
            het=HeterogeneityConfig(num_workers=args.workers, sigma=args.sigma),
            engine=args.engine,
            round_fusion=args.round_fusion,
            compute=args.compute,
            compute_blocks=tuple(int(v) for v in args.compute_blocks.split(",")),
            scenario=scenario,
            async_window=args.async_window,
            device=args.device,
            **model,
        )
        if args.mesh_devices:
            r = run_ranks(args.mesh_devices, simulate, (sim,), device=args.device)[0]
        else:
            r = run_simulation(sim)
        results[method] = r
        print(f"[{method:9s}] best_acc={r.best_acc:.3f} time={r.total_time:.0f}s "
              f"param_red={r.param_reduction:.1%} "
              f"(host: {r.walltime_s:.1f}s, {r.recompiles} compiles, "
              f"{r.host_roundtrips} roundtrips, engine={r.engine})")
        if args.mesh_devices:
            print(f"            mesh: {r.n_devices} devices x "
                  f"W_local={args.workers // r.fleet_axis_size} "
                  f"spec={r.shard_spec}")
        if args.compute == "block_skip":
            print(f"            compute=block_skip: "
                  f"flops_exec/ideal={r.flops_executed / max(r.flops_ideal, 1e-9):.3f} "
                  f"blocks/img(final)={r.blocks_per_image_final:.0f}")
        if method == "adaptcl":
            print(f"            retentions={[round(g, 2) for g in r.retentions]}")
            hs = [f"{h:.2f}" for _, h in r.het_traj[:: max(1, args.rounds // 8)]]
            print(f"            heterogeneity trajectory: {' -> '.join(hs)}")

    if len(methods) > 1:
        base, last = results[methods[0]], results[methods[-1]]
        note = "  (paper at sigma=2: 1.78x)" if methods == ["fedavg_s", "adaptcl"] else ""
        print(f"\n{methods[-1]} vs {methods[0]} speedup: "
              f"{base.total_time / last.total_time:.2f}x{note}   "
              f"dAcc={last.best_acc - base.best_acc:+.3f}")


if __name__ == "__main__":
    main()
