"""Worker-side local training (AdaptCL Alg. 1, worker part), resident path.

Port of ``repro/core/worker.py``: the batch-plan helpers (host numpy, the
same RNG stream as the reference) and ``LocalTrainer.train_resident``, the
masked base-shape trainer over device-resident ``[B, ...]`` worker stacks.
The JAX package vmaps one worker's ``lax.scan`` over the stack; here the
worker dimension is written out and the scan is a Python loop over steps.

Each step is validity-gated: an invalid step computes and discards (params,
momentum and loss keep their carry), so ragged plans and non-participating
rows share one call.  Momentum restarts at zero per call (per phase), as in
the reference engines.

Counters, defined for PyTorch (which has no jit):

* ``compile_count`` (``SimResult.recompiles``): distinct training-call
  signatures (stack rows, shard shape, plan shape, lam) seen;
* ``dispatch_count`` (``SimResult.host_dispatches``): fleet training calls
  plus evaluation calls;
* ``compile_walltime_s``: wall time of the FIRST call of each signature
  (training and evaluation), run to completion (``torch.cuda.synchronize``
  on the card) — the warm-up share of the run's walltime.
"""
from __future__ import annotations

import time as _time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.cnn import CNNConfig, cnn_apply, prunable_layer_names
from repro_torch.optim.group_lasso import group_lasso_penalty
from repro_torch.optim.optimizers import apply_updates, momentum

__all__ = ["LocalTrainer", "make_batch_plan", "plan_steps", "stack_batch_plans"]

Tensors = Dict[str, torch.Tensor]


def make_batch_plan(
    n: int, batch_size: int, epochs: float, rng: np.random.Generator
) -> np.ndarray:
    """Pre-draw the minibatch index sequence for one local training phase:
    ``[steps, batch_size]`` int64 indices into the worker's shard (a fresh
    permutation per epoch, the short final batch padded from the epoch's
    head, fractional epochs honoured).  ``epochs <= 0`` consumes no RNG."""
    if epochs <= 0 or n <= 0:
        return np.zeros((0, batch_size), dtype=np.int64)
    total = max(1, int(round(epochs * n)))
    sels = []
    done = 0
    while done < total:
        order = rng.permutation(n)
        for i in range(0, n, batch_size):
            if done >= total:
                break
            sel = order[i : i + batch_size]
            if len(sel) < batch_size:
                sel = np.concatenate([sel, order[: batch_size - len(sel)]])
            sels.append(sel.astype(np.int64))
            done += batch_size
    return np.stack(sels)


def plan_steps(n: int, batch_size: int, epochs: float) -> int:
    """Steps ``make_batch_plan(n, batch_size, epochs, ...)`` draws, without
    consuming RNG state (the fleet's constant per-phase step pad)."""
    if epochs <= 0 or n <= 0:
        return 0
    total = max(1, int(round(epochs * n)))
    return -(-total // batch_size)


def stack_batch_plans(
    plans: Sequence[Optional[np.ndarray]],
    num_rows: Optional[int] = None,
    num_steps: Optional[int] = None,
):
    """Pad per-row plans into ``[R, S, batch]`` + a ``[R, S]`` validity mask
    (``None``/empty plan = fully invalid row); ``None`` when no row has a
    step and no padding was requested."""
    steps = [0 if p is None else p.shape[0] for p in plans]
    S = max(steps) if steps else 0
    if num_steps is not None:
        S = max(S, num_steps)
    if S == 0:
        return None
    R = len(plans)
    if num_rows is not None:
        R = max(R, num_rows)
    batch = next((p.shape[1] for p in plans if p is not None and p.shape[0] > 0), 1)
    stack = np.zeros((R, S, batch), np.int64)
    valid = np.zeros((R, S), np.float32)
    for w, p in enumerate(plans):
        if steps[w]:
            stack[w, : steps[w]] = p
            valid[w, : steps[w]] = 1.0
    return stack, valid


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LocalTrainer:
    """Minibatch SGD + momentum with optional group-lasso sparse training,
    over masked base-shape worker stacks.

    ``compute`` selects the device dispatch: ``"dense"`` runs grouped convs
    at base shape (masks as 0/1 multiplies — full FLOPs), ``"block_skip"``
    lowers convs and head onto the block-skip kernel with per-worker unit
    masks read off each worker's ``bn_g`` mask row, so a pruned worker's
    device FLOPs track its retention."""

    def __init__(
        self,
        cnn_cfg: CNNConfig,
        lr: float = 0.05,
        beta: float = 0.9,
        compute: str = "dense",
        compute_blocks: Tuple[int, int, int] = (128, 128, 128),
        device="cpu",
    ):
        if compute not in ("dense", "block_skip"):
            raise ValueError(f"unknown compute path {compute!r}")
        self.cfg = cnn_cfg
        self.lr = lr
        self.beta = beta
        self.compute = compute
        self.compute_blocks = tuple(compute_blocks)
        self.device = torch.device(device)
        self._prunable = prunable_layer_names(cnn_cfg)
        self._seen: set = set()
        self.compile_count = 0
        self.dispatch_count = 0
        self.compile_walltime_s = 0.0
        self.steps_run = 0          # optimizer steps run over stacks (padding included)

    def dispatch(self, sig, fn, *args, count_compile: bool = True):
        """Run ``fn(*args)`` as one counted host dispatch; the first call of
        each signature is run to completion and timed."""
        first = sig not in self._seen
        if first:
            self._seen.add(sig)
            if count_compile:
                self.compile_count += 1
        self.dispatch_count += 1
        if not first:
            return fn(*args)
        t0 = _time.perf_counter()
        out = fn(*args)
        _sync(self.device)
        self.compile_walltime_s += _time.perf_counter() - t0
        return out

    def masked_logits(self, qm: Tensors, mask: Tensors, xb: torch.Tensor) -> torch.Tensor:
        """Logits of the masked stack ``[B, n, classes]``; the block-skip path
        reads each prunable layer's unit mask off its ``bn_g`` mask row."""
        if self.compute == "block_skip":
            um = {n: mask[f"{n}/bn_g"] for n in self._prunable}
            return cnn_apply(
                qm, self.cfg, xb, compute="block_skip", unit_masks=um,
                blocks=self.compute_blocks,
            )
        return cnn_apply(qm, self.cfg, xb)

    def _resident(self, params, masks, unit_map, xs, ys, plans, valid, lam, gl_sizes):
        opt = momentum(self.lr, self.beta)
        B, S, _ = plans.shape
        rows = torch.arange(B, device=xs.device)[:, None]
        p = {k: v.detach() for k, v in params.items()}
        st = opt.init(p)
        loss_sum = torch.zeros(B, device=xs.device)
        self.steps_run += S
        for s in range(S):
            sel = plans[:, s, :]
            xb, yb = xs[rows, sel], ys[rows, sel]
            q = {k: v.requires_grad_(True) for k, v in p.items()}
            qm = {k: q[k] * masks[k] for k in q}
            logp = F.log_softmax(self.masked_logits(qm, masks, xb), dim=-1)
            ce = -logp.gather(-1, yb.unsqueeze(-1)).squeeze(-1).mean(dim=1)   # [B]
            loss = ce
            if lam > 0.0:
                loss = loss + group_lasso_penalty(
                    qm, unit_map, lam, size_sqrt=gl_sizes, batch_dims=1
                )
            keys = list(q)
            grads = torch.autograd.grad(loss.sum(), [q[k] for k in keys])
            with torch.no_grad():
                g = dict(zip(keys, grads))
                q = {k: v.detach() for k, v in q.items()}
                updates, st2 = opt.update(g, st)
                q2 = apply_updates(q, updates)
                vb = valid[:, s] > 0
                gate = lambda a, b: torch.where(vb.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
                p = {k: gate(q2[k], q[k]) for k in q}
                st = {k: gate(st2[k], st[k]) for k in st}
                loss_sum = loss_sum + torch.where(vb, loss.detach(), torch.zeros_like(loss))
        with torch.no_grad():
            p = {k: v * masks[k] for k, v in p.items()}
            steps = torch.clamp_min(valid.sum(1), 1.0)
            return p, loss_sum / steps

    def train_resident(
        self,
        params_stack: Tensors,            # [B, ...] base-shape stacks
        masks_stack: Tensors,             # [B, ...] 0/1
        unit_map,
        xs: torch.Tensor,                 # [B, n_max, H, W, 3] padded shards
        ys: torch.Tensor,                 # [B, n_max]
        plans: torch.Tensor,              # [B, steps, batch] int64
        valid: torch.Tensor,              # [B, steps] 1.0 = real step
        lam: float,
        gl_sizes: Mapping[str, torch.Tensor],   # {lname: [B]} sqrt-group-size factors
    ):
        """One counted call over a whole worker stack.  Returns
        ``(params_stack, losses[B])``, both on the device."""
        sig = ("resident", tuple(xs.shape), tuple(plans.shape), float(lam))
        return self.dispatch(
            sig, self._resident, params_stack, masks_stack, unit_map,
            xs, ys, plans, valid, lam, gl_sizes,
        )
