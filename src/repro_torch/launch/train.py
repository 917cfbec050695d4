"""Training launcher for the LLM path (port of ``repro/launch/train.py``).

``train_loop`` trains a model on the synthetic token task with AdamW:
``make_train_step`` takes the loss and every gradient by autograd through
``models.transformer.lm_loss`` (attention through the flash kernel and the
RG-LRU / sLSTM recurrences through the scan kernel, each with its backward
kernel on the card), then the optimizer's step.  The step updates the
params and the optimizer state in place (``Optimizer.step_``), with the
reference's operations, so a step on the card holds the params, one
gradient tree and the state, and no second copy of any.  Runs on the card
unless ``device="cpu"`` is given; ``device="cuda"`` without a card raises.
Float32 products run in IEEE float32 (``ieee_f32``: TF32 off) for the run.

The reference's init draws from ``jax.random``, which the port cannot
replay: ``train_loop(..., params=...)`` takes a given init (the reference's,
through ``convert.tree_from_numpy``); without one the port draws its own
from ``seed``.  The reference's module docstring mentions a collaborative
``--workers N`` mode that its ``main`` does not have; neither has the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch recurrentgemma-9b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.simulation import ieee_f32, resolve_device
from repro_torch.data.synthetic import SyntheticLMTask
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, apply_retention, param_count
from repro_torch.optim.optimizers import adamw, tree_leaves, tree_map

__all__ = ["loss_and_grads", "make_train_step", "train_batch", "train_loop", "main",
           "ENC_FRAMES", "SEQ_LEN"]

# The reference train_loop's sequence length and zero encoder frames.
SEQ_LEN = 64
ENC_FRAMES = 16


def loss_and_grads(params, cfg: ModelConfig, batch):
    """``(loss, grads)`` of ``lm_loss`` at ``params``; ``grads`` is a tree
    like ``params`` (``jax.value_and_grad``)."""
    leaves = tree_leaves(params)
    was = [p.requires_grad for p in leaves]
    try:
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss = T.lm_loss(params, cfg, batch)
            grads = iter(torch.autograd.grad(loss, leaves))
    finally:
        # the params leave as they came: a later forward records no graph
        for p, w in zip(leaves, was):
            p.requires_grad_(w)
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(cfg: ModelConfig, opt):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``;
    ``params`` and the state are updated in place."""

    def step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, cfg, batch)
        with torch.no_grad():
            opt_state = opt.step_(params, grads, opt_state)
        return params, opt_state, loss

    return step


def train_batch(cfg: ModelConfig, toks: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """The reference loop's batch: the tokens, and zero prefix embeddings or
    ``ENC_FRAMES`` zero encoder frames where the model takes them."""
    b = toks.shape[0]
    dt = T.param_dtype(cfg)
    out = {"tokens": torch.as_tensor(toks, dtype=torch.long, device=device)}
    if cfg.num_prefix_embeds:
        out["prefix_embeds"] = torch.zeros(b, cfg.num_prefix_embeds, cfg.d_model, dtype=dt,
                                           device=device)
    if cfg.encoder_layers:
        out["enc_embeds"] = torch.zeros(b, ENC_FRAMES, cfg.d_model, dtype=dt, device=device)
    return out


def train_loop(
    cfg: ModelConfig,
    steps: int = 100,
    batch: int = 8,
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 10,
    *,
    params=None,
    device="cuda",
):
    """Returns ``(params, losses, seconds)`` as the reference's.  ``params``
    must already lie on ``device``; it is trained in place."""
    dev = resolve_device(device, "train_loop device")
    T.validate_config(cfg)
    if params is None:
        params = T.init_params(torch.Generator(device=dev).manual_seed(seed), cfg)
    elif params["embed"].device.type != dev.type:
        raise ValueError(f"params lie on {params['embed'].device}, train_loop runs on {dev}")
    opt = adamw(lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt)
    task = SyntheticLMTask(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN, seed=seed)
    rng = np.random.default_rng(seed)
    losses = []
    with ieee_f32():
        t0 = time.perf_counter()
        for i in range(steps):
            b = train_batch(cfg, task.sample(batch, rng), dev)
            params, opt_state, loss = step_fn(params, opt_state, b)
            losses.append(float(loss))
            if log_every and (i + 1) % log_every == 0:
                print(f"step {i+1:4d} loss {np.mean(losses[-log_every:]):.4f}")
        dt = time.perf_counter() - t0
    return params, losses, dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--retention", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device, "train --device")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.retention < 1.0:
        cfg = apply_retention(cfg, args.retention)
    print(f"[train] {cfg.name} retention={cfg.retention} params={param_count(cfg):,}")
    params, losses, dt = train_loop(cfg, args.steps, args.batch, args.lr, device=args.device)
    print(f"[train] {args.steps} steps in {dt:.1f}s; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert np.isfinite(losses[-1])
    return losses


if __name__ == "__main__":
    main()
