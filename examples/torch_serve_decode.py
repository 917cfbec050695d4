"""Batched serving example on the port: prefill + ring-buffer decode on a
reduced config, including a capability-adapted (AdaptCL-pruned) replica —
the serving-side analogue of the paper's heterogeneous workers (port of
``examples/serve_decode.py``, with ``--device``).

    PYTHONPATH=src python examples/torch_serve_decode.py [--arch recurrentgemma-9b] [--device cpu]

Runs on the card unless ``--device cpu`` is given, and raises without one.
Weights and prompts are seeded random (``torch.Generator``), so the sampled
tokens are the port's own, not the JAX example's.  ``--arch whisper-small``
feeds 16 zero encoder frames and ``--arch internvl2-76b`` its zero prefix
embeddings, as ``python -m repro_torch.launch.serve`` does.
"""
import argparse
import time

import torch

from repro_torch.configs import list_archs, smoke_config
from repro_torch.core.simulation import resolve_device
from repro_torch.launch.serve import extra_inputs, serve_batch
from repro_torch.models import transformer as T
from repro_torch.models.config import apply_retention, param_count


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-9b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "torch_serve_decode --device")

    for gamma in (1.0, 0.5):
        cfg = smoke_config(args.arch)
        if gamma < 1.0:
            cfg = apply_retention(cfg, gamma)
        params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        prompts = torch.randint(0, cfg.vocab_size, (args.batch, 16),
                                generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        t0 = time.perf_counter()
        gen = serve_batch(cfg, params, prompts, args.new_tokens, extra_inputs(cfg, args.batch, dev),
                          device=args.device)
        dt = time.perf_counter() - t0
        print(f"[serve] {args.arch} gamma={gamma}: {param_count(cfg):,} params, "
              f"{args.batch * args.new_tokens / dt:6.1f} tok/s, sample {gen[0].cpu().numpy()[:6]}")


if __name__ == "__main__":
    main()
