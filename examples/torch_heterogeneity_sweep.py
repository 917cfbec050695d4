"""Tab. IV reproduction script on the port: AdaptCL speedup vs
heterogeneity level, on the card by default.

Port of ``examples/heterogeneity_sweep.py``, with its flags and print lines.

    PYTHONPATH=src python examples/torch_heterogeneity_sweep.py [--rounds 16] [--device cpu]
"""
import argparse

from repro_torch.bench.run import MODELS
from repro_torch.core.simulation import SimConfig, run_simulation
from repro_torch.core.timing import HeterogeneityConfig, heterogeneity_closed_form


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--sigmas", type=float, nargs="+", default=[2.0, 5.0, 10.0, 20.0])
    ap.add_argument("--engine", default="masked",
                    choices=("sequential", "bucketed", "masked"),
                    help="fleet engine; masked batches the sweep's local training")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cnn", default="default", choices=tuple(MODELS),
                    help="model: the simulator's default small VGG, "
                         "VGG16_CIFAR or RESNET50_TINY")
    args = ap.parse_args()
    common = dict(engine=args.engine, noniid_s=80.0, device=args.device)
    if MODELS[args.cnn] is not None:
        common["cnn"] = MODELS[args.cnn]
    print(f"{'H(sigma)':>10s} {'speedup':>8s} {'dAcc':>8s} {'param_red':>10s}")
    for sigma in args.sigmas:
        fed = run_simulation(SimConfig(method="fedavg_s", rounds=args.rounds,
                                       het=HeterogeneityConfig(sigma=sigma), **common))
        ada = run_simulation(SimConfig(method="adaptcl", rounds=args.rounds, prune_interval=4,
                                       het=HeterogeneityConfig(sigma=sigma), **common))
        h = heterogeneity_closed_form(10, sigma)
        print(f"{h:6.2f}({sigma:>4.0f}) {fed.total_time/ada.total_time:7.2f}x "
              f"{ada.best_acc - fed.best_acc:+8.3f} {ada.param_reduction:9.1%}")
    print("(paper Tab. IV: 1.78x/3.15x/4.85x/6.20x at H=0.32/0.62/0.76/0.87)")


if __name__ == "__main__":
    main()
