"""Quickstart on the port: train a reduced assigned-architecture config on
synthetic LM data, then serve a capability-adapted sub-model of it; the
60-second tour of the public API (port of ``examples/quickstart.py``, with
``--device``).

    PYTHONPATH=src python examples/torch_quickstart.py [--arch gemma2-2b] [--device cpu]

Runs on the card unless ``--device cpu`` is given, and raises without one.
Weights and prompts are seeded random (``torch.Generator``), so the losses
and tokens are the port's own, not the JAX example's.
"""
import argparse

import torch

from repro_torch.configs import list_archs, smoke_config
from repro_torch.core.simulation import resolve_device
from repro_torch.launch.serve import serve_batch
from repro_torch.launch.train import train_loop
from repro_torch.models import transformer as T
from repro_torch.models.config import apply_retention, param_count


def main(argv=None):
    """Prints the reference's three lines; returns the trained params and
    losses, and the sub-model's config and generated tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "quickstart --device")

    cfg = smoke_config(args.arch)
    print(f"[quickstart] {cfg.name} (reduced): {param_count(cfg):,} params")
    params, losses, dt = train_loop(cfg, steps=args.steps, batch=8, lr=1e-3, device=dev)
    print(f"[quickstart] trained {args.steps} steps in {dt:.1f}s: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "loss should decrease"

    # AdaptCL: reconfigure to a 60%-retention sub-model and serve it
    sub_cfg = apply_retention(cfg, 0.6)
    sub_params = T.init_params(torch.Generator(device=dev).manual_seed(1), sub_cfg)
    prompts = torch.randint(0, cfg.vocab_size, (2, 16),
                            generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    gen = serve_batch(sub_cfg, sub_params, prompts, new_tokens=8, device=dev)
    print(f"[quickstart] gamma=0.6 sub-model ({param_count(sub_cfg):,} params) "
          f"served {gen.shape[1]} tokens/prompt: {gen[0].cpu().numpy()}")
    return {"cfg": cfg, "params": params, "losses": losses, "seconds": dt,
            "sub_cfg": sub_cfg, "prompts": prompts, "generated": gen}


if __name__ == "__main__":
    main()
