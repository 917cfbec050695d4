"""Serving launcher: prefill + batched greedy decode (port of
``repro/launch/serve.py``).

A batch of prompts -> ``prefill`` builds the ring-buffer KV caches and
recurrent states (attention through the flash kernel, the RG-LRU
recurrence through the scan kernel) -> token-by-token greedy decode.  An
encoder-decoder (whisper-small) takes its encoder frames and a
vision-prefix model (internvl2-76b) its prefix embeddings through
``extra_batch``; ``main`` builds them as the reference's does (zeros: 16
frames, ``num_prefix_embeds`` embeddings).
``--retention`` serves an AdaptCL-reconfigured sub-model.  Runs on the card
unless ``--device cpu`` is given; ``device="cuda"`` without a card raises.
The model's dtype is its config's (``ModelConfig.dtype``, float32 or the
JAX dry-run's bfloat16: ``cfg.replace(dtype="bfloat16")``); as in the JAX
``launch/serve.py`` there is no flag for it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Dict, Optional

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.simulation import ieee_f32, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import apply_retention

__all__ = ["serve_batch", "serve_numerics", "extra_inputs", "main", "CLI_ENC_FRAMES"]

# Encoder frames of the CLI's stubbed audio frontend (repro/launch/serve.py:62).
CLI_ENC_FRAMES = 16


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def serve_numerics():
    """For the duration of a serve: ``ieee_f32`` (TF32 off), and cuBLAS's
    bf16 GEMMs reduced in float32 (no reduced-precision split-K
    reduction), as XLA's bf16 dot accumulates; the caller's flags come
    back on exit."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    with ieee_f32():
        matmul.allow_bf16_reduced_precision_reduction = False
        try:
            yield
        finally:
            matmul.allow_bf16_reduced_precision_reduction = saved


def serve_batch(cfg, params, prompts: torch.Tensor, new_tokens: int = 16, extra_batch=None, *,
                device="cuda", stats: Optional[Dict] = None, return_logits: bool = False):
    """prompts [b, s] -> generated [b, new_tokens] (greedy), on ``device``.

    ``params`` must already lie on ``device`` (nothing is moved quietly).
    ``extra_batch`` adds ``enc_embeds`` / ``prefix_embeds`` to the prefill's
    batch (moved to ``device``).  The cache holds the prefix too: its
    capacity is ``P + s + new_tokens`` for a prefix of ``P`` embeddings
    (the reference's ``s + new_tokens`` would push the prefix out of every
    full-attention layer's ring once ``P > new_tokens``).
    With ``stats`` a dict, the prefill and decode wall seconds are written
    into it (the device is synchronised at each boundary).  With
    ``return_logits``, also returns the ``[b, new_tokens + 1, V]`` logits:
    the prefill's (position s-1) and each decode step's (positions s ..
    s+new_tokens-1).  Runs in the config's dtype under ``serve_numerics``
    (float32 products in IEEE float32, bf16 products accumulated and
    reduced in float32), restoring the caller's flags."""
    dev = resolve_device(device, "serve_batch device")
    T.validate_config(cfg)
    leaf = params["embed"]
    if leaf.device.type != dev.type:
        raise ValueError(f"params lie on {leaf.device}, serve_batch runs on {dev}")
    prompts = prompts.to(dev)
    b, s = prompts.shape
    batch = {"tokens": prompts, **{k: v.to(dev) for k, v in (extra_batch or {}).items()}}
    max_len = T._prefix_len(cfg, batch) + s + new_tokens
    kept = []
    with serve_numerics():
        _sync(dev)
        t0 = time.perf_counter()
        logits, state = T.prefill(params, cfg, batch, max_len=max_len)
        if stats is not None:
            _sync(dev)
            stats["prefill_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        out = []
        tok = torch.argmax(logits, dim=-1)
        for _ in range(new_tokens):
            if return_logits:
                kept.append(logits)
            out.append(tok)
            logits, state = T.decode_step(params, cfg, state, tok)
            tok = torch.argmax(logits, dim=-1)
        if return_logits:
            kept.append(logits)
        gen = torch.stack(out, dim=1) if out else prompts.new_zeros((b, 0))
        if stats is not None:
            _sync(dev)
            stats["decode_s"] = time.perf_counter() - t1
    if return_logits:
        return gen, torch.stack(kept, dim=1)
    return gen


def extra_inputs(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    """The reference CLI's extra batch: zero prefix embeddings for a
    vision-prefix model, ``CLI_ENC_FRAMES`` zero encoder frames for an
    encoder-decoder (the stubbed frontends' outputs), in the model dtype."""
    dt, extra = T.param_dtype(cfg), {}
    if cfg.num_prefix_embeds:
        extra["prefix_embeds"] = torch.zeros(batch, cfg.num_prefix_embeds, cfg.d_model,
                                             dtype=dt, device=device)
    if cfg.encoder_layers:
        extra["enc_embeds"] = torch.zeros(batch, CLI_ENC_FRAMES, cfg.d_model, dtype=dt, device=device)
    return extra


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--retention", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, "serve --device")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.retention < 1.0:
        cfg = apply_retention(cfg, args.retention)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(gen, cfg)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    stats: Dict = {}
    t0 = time.perf_counter()
    out = serve_batch(cfg, params, prompts, args.new_tokens, extra_inputs(cfg, args.batch, dev),
                      device=args.device, stats=stats)
    dt = time.perf_counter() - t0
    tps = args.batch * args.new_tokens / dt
    print(f"[serve] {cfg.name} retention={cfg.retention} on {dev}: generated "
          f"{tuple(out.shape)} in {dt:.2f}s ({tps:.1f} tok/s; prefill "
          f"{stats['prefill_s']:.3f}s, decode {stats['decode_s']:.3f}s); "
          f"sample: {out[0, :8].tolist()}")
    return out


if __name__ == "__main__":
    main()
