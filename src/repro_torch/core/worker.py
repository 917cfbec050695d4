"""Worker-side logic (AdaptCL Alg. 1, worker part): SparseTrain ->
NetworkPrune -> NetworkReconfigure.

Port of ``repro/core/worker.py``: the batch-plan helpers (host numpy, the
same RNG stream as the reference) and ``LocalTrainer``'s three training
entry points, which share one step loop (the JAX package vmaps one worker's
``lax.scan``; here the worker dimension ``B`` is written out and the scan is
a Python loop over steps):

* ``train_plan``     — one physically small worker (the sequential engine);
* ``train_many``     — a stack of same-shaped workers in one call (the
  bucketed engine), or of base-shape workers under 0/1 masks (the masked
  engine's ``FleetEngine.train_all``);
* ``train_resident`` — the masked base-shape stack of the resident engine,
  each step validity-gated: an invalid step computes and discards (params,
  momentum and loss keep their carry), so ragged plans and
  non-participating rows share one call.

Momentum restarts at zero per call (per phase), as in the reference
engines, unless ``train_resident`` is handed a momentum stack to carry
(``SimConfig.resident_momentum``).  ``gradient`` and ``local_unit_stats``
give the data-dependent importance signals; ``prune_and_reconfigure``
slices a sub-model down.

Counters, defined for PyTorch (which has no jit):

* ``compile_count`` (``SimResult.recompiles``): distinct call signatures
  seen, keyed as the reference keys its jit cache (param shapes, call kind,
  stack rows, shard and plan shapes, lam);
* ``dispatch_count`` (``SimResult.host_dispatches``): training, gradient
  and evaluation calls;
* ``compile_walltime_s``: wall time of the FIRST call of each signature
  (training and evaluation), run to completion (``torch.cuda.synchronize``
  on the card) — the warm-up share of the run's walltime.
"""
from __future__ import annotations

import time as _time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.cnn import CNNConfig, cnn_apply, prunable_layer_names
from repro_torch.optim.group_lasso import group_lasso_penalty, group_size_sqrt, unit_group_norms
from repro_torch.optim.optimizers import apply_updates, momentum

from .masks import GlobalIndex, prune_to_budget

__all__ = [
    "LocalTrainer",
    "make_batch_plan",
    "plan_steps",
    "stack_batch_plans",
    "reslice_subparams",
    "local_unit_stats",
]

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


def reslice_subparams(
    params: Tensors, old_index: GlobalIndex, new_index: GlobalIndex, unit_map
) -> Tensors:
    """Slice a sub-model further down: ``new_index`` must nest inside
    ``old_index``."""
    rel: Dict[str, np.ndarray] = {}
    for lname, old in old_index.items():
        pos = {int(u): i for i, u in enumerate(old)}
        rel[lname] = np.array([pos[int(u)] for u in new_index[lname]], dtype=np.int64)
    out: Tensors = {}
    for path, arr in params.items():
        for lname, axis in unit_map.get(path, ()):
            arr = torch.index_select(arr, axis, torch.as_tensor(rel[lname], device=arr.device))
        out[path] = arr
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LocalTrainer:
    """Minibatch SGD + momentum with optional group-lasso sparse training.

    ``compute`` selects the masked (resident) path's device dispatch:
    ``"dense"`` runs grouped convs at base shape (masks as 0/1 multiplies —
    full FLOPs), ``"block_skip"`` lowers convs and head onto the block-skip
    kernel with per-worker unit masks read off each worker's ``bn_g`` mask
    row, so a pruned worker's device FLOPs track its retention.  The
    reconfigured paths (``train_plan``, ``train_many``) run physically
    small models, already sized, through the dense convs."""

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

    def _ce(self, logits: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy over the last-but-one dim: one value per row."""
        logp = F.log_softmax(logits, dim=-1)
        return -logp.gather(-1, yb.unsqueeze(-1)).squeeze(-1).mean(dim=-1)

    def _plan_sig(self, params: Mapping[str, torch.Tensor], extra, lam: float) -> tuple:
        return (tuple(sorted((k, tuple(v.shape)) for k, v in params.items())), extra, float(lam))

    def _train_stack(self, params, masks, unit_map, xs, ys, plans, valid, lam, gl_sizes,
                     momentum_in=None):
        """SGD + momentum over a ``[B, ...]`` stack through its ``[B, S,
        batch]`` plans.  ``masks`` (0/1 stacks) runs the masked base-shape
        model, the unit masks read off the ``bn_g`` rows; ``None`` runs the
        params as they are.  ``valid`` ([B, S]) gates each step, ``None``
        runs them all.  ``gl_sizes`` ({lname: [B]}) sets the group-lasso
        factors, ``None`` takes them from the params' shapes.  The momentum
        starts from ``momentum_in`` when given, else from zeros.  Returns
        ``(params, momentum, mean losses [B])``."""
        opt = momentum(self.lr, self.beta)
        B, S, _ = plans.shape
        rows = torch.arange(B, device=xs.device)[:, None]
        p = {k: v.detach() for k, v in params.items()}
        if momentum_in is None:
            st = opt.init(p)
        else:
            st = {k: v.detach() for k, v in momentum_in.items()}
        loss_sum = torch.zeros(B, device=xs.device)
        self.steps_run += S
        for s in range(S):
            sel = plans[:, s, :]
            xb, yb = xs[rows, sel], ys[rows, sel]
            q = {k: v.requires_grad_(True) for k, v in p.items()}
            if masks is None:
                qm = q
                logits = cnn_apply(qm, self.cfg, xb)
            else:
                qm = {k: q[k] * masks[k] for k in q}
                logits = self.masked_logits(qm, masks, xb)
            loss = self._ce(logits, yb)                                 # [B]
            if lam > 0.0:
                loss = loss + group_lasso_penalty(
                    qm, unit_map, lam, size_sqrt=gl_sizes, batch_dims=1
                )
            keys = list(q)
            grads = torch.autograd.grad(loss.sum(), [q[k] for k in keys])
            with torch.no_grad():
                g = dict(zip(keys, grads))
                q = {k: v.detach() for k, v in q.items()}
                updates, st2 = opt.update(g, st, q)
                q2 = apply_updates(q, updates)
                if valid is None:
                    p, st = q2, st2
                    loss_sum = loss_sum + loss.detach()
                    continue
                vb = valid[:, s] > 0
                gate = lambda a, b: torch.where(vb.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
                p = {k: gate(q2[k], q[k]) for k in q}
                st = {k: gate(st2[k], st[k]) for k in st}
                loss_sum = loss_sum + torch.where(vb, loss.detach(), torch.zeros_like(loss))
        with torch.no_grad():
            if masks is not None:
                p = {k: v * masks[k] for k, v in p.items()}
            steps = torch.full((B,), float(S), device=xs.device) if valid is None else valid.sum(1)
            return p, st, loss_sum / torch.clamp_min(steps, 1.0)

    def _device_data(self, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(x, device=self.device),
                torch.as_tensor(np.asarray(y, np.int64), device=self.device))

    def train_plan(
        self, params: Tensors, unit_map, x: np.ndarray, y: np.ndarray,
        plan: np.ndarray, lam: float = 0.0,
    ) -> Tuple[Tensors, torch.Tensor]:
        """Train one (physically small) worker through a pre-drawn
        ``make_batch_plan`` plan, one counted call; returns (params, mean
        loss).  An empty plan returns the params untouched, uncounted."""
        if plan.shape[0] == 0:
            return dict(params), torch.tensor(float("nan"))
        sig = self._plan_sig(params, ("plan", tuple(x.shape), tuple(plan.shape)), lam)
        xs, ys = self._device_data(x[None], y[None])
        plans = torch.as_tensor(plan[None], device=self.device)

        def run():
            out, _, losses = self._train_stack(
                {k: v.unsqueeze(0) for k, v in params.items()}, None, unit_map,
                xs, ys, plans, None, lam, None,
            )
            return {k: v[0] for k, v in out.items()}, losses[0]

        return self.dispatch(sig, run)

    def train_many(
        self, params_list: Sequence[Tensors], unit_map, xs: np.ndarray, ys: np.ndarray,
        plans: np.ndarray, lam: float = 0.0,
        masks: Optional[Sequence[Mapping[str, torch.Tensor]]] = None,
        gl_sizes: Optional[Sequence[Mapping[str, float]]] = None,
    ) -> Tuple[List[Tensors], torch.Tensor]:
        """Train a stack of same-shaped workers (``xs [B, n, ...]``, ``plans
        [B, steps, batch]``) in ONE counted call; returns the trained params
        per worker and the ``[B]`` mean losses.

        ``masks`` (per worker, 0/1 at the params' shapes) turns on the masked
        mode: heterogeneous sub-models ride the base shape as unit masks, so
        gradients and momentum are exactly zero on pruned coordinates, and
        ``compute="block_skip"`` runs the block-skip kernel.  ``gl_sizes``
        (per worker, ``{layer: sqrt|g|}``) sets the group-lasso factors; by
        default they come from the stack's own shapes."""
        B = len(params_list)
        if not (xs.shape[0] == ys.shape[0] == plans.shape[0] == B):
            raise ValueError("train_many: params, shards and plans disagree on the stack size")
        stacked = {k: torch.stack([p[k] for p in params_list]) for k in params_list[0]}
        masked = masks is not None
        sig = self._plan_sig(
            params_list[0], ("many", B, tuple(xs.shape[1:]), tuple(plans.shape[1:]), masked), lam
        )
        xt, yt = self._device_data(xs, ys)
        pt = torch.as_tensor(plans, device=self.device)
        mt = gl = None
        if masked:
            mt = {k: torch.stack([torch.as_tensor(m[k], dtype=torch.float32, device=self.device)
                                  for m in masks]) for k in params_list[0]}
            if gl_sizes is None:   # the shapes the stack runs at
                gl_sizes = [group_size_sqrt(p, unit_map) for p in params_list]
            gl = {lname: torch.as_tensor([s[lname] for s in gl_sizes], dtype=torch.float32,
                                         device=self.device)
                  for lname in gl_sizes[0]}
        out, _, losses = self.dispatch(
            sig, self._train_stack, stacked, mt, unit_map, xt, yt, pt, None, lam, gl
        )
        return [{k: v[i] for k, v in out.items()} for i in range(B)], losses

    def gradient(self, params: Tensors, unit_map, x, y, lam: float = 0.0) -> Tensors:
        """One-batch gradient of the (physically small) model's loss, one
        counted call keyed ``(shapes, "grad", lam)``."""
        xt, yt = self._device_data(x, y)

        def run():
            q = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            loss = self._ce(cnn_apply(q, self.cfg, xt), yt)
            if lam > 0.0:
                loss = loss + group_lasso_penalty(q, unit_map, lam)
            return dict(zip(q, torch.autograd.grad(loss, list(q.values()))))

        return self.dispatch(self._plan_sig(params, "grad", lam), run)

    def prune_and_reconfigure(
        self, params: Tensors, index: GlobalIndex, scores: Mapping[str, np.ndarray],
        pruned_rate: float, space, unit_map,
    ) -> Tuple[Tensors, GlobalIndex]:
        """Alg. 1 lines 3-5: prune to the budget, then slice the sub-model."""
        new_index = prune_to_budget(index, scores, pruned_rate, space)
        return reslice_subparams(params, index, new_index, unit_map), new_index

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
        momentum_in: Optional[Tensors] = None,  # [B, ...] cross-round carry
    ):
        """One counted call over a whole worker stack.  Returns
        ``(params_stack, momentum_stack, losses[B])``, all on the device.
        With ``momentum_in`` the optimizer starts from that stack instead of
        zeros (cross-round resident momentum); the returned stack is the
        next carry.  Pruned coordinates get zero gradients, so momentum that
        is zero there stays exactly zero."""
        sig = ("resident", tuple(xs.shape), tuple(plans.shape), momentum_in is not None,
               float(lam))
        return self.dispatch(
            sig, self._train_stack, params_stack, masks_stack, unit_map,
            xs, ys, plans, valid, lam, gl_sizes, momentum_in,
        )


def local_unit_stats(
    trainer: LocalTrainer,
    params: Tensors,
    index: GlobalIndex,
    space,
    unit_map,
    x,
    y,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Data/sub-model-dependent importance signals of a physically small
    sub-model on its shard, scattered to base unit coordinates (absent units
    get -inf, so they sort as already pruned), float64:

    * ``weight_norms`` — per-unit group L2 norms (L1 / FPGM);
    * ``grads`` — Taylor |sum g*w| per unit, the gradient on the first 64
      shard images (``trainer.gradient``, one counted call);
    * ``activations`` — mean |activation| after each prunable conv's ReLU on
      the same images (HRank proxy), from ``cnn_apply(stats=...)``.
    """
    norms, _ = unit_group_norms(params, unit_map)
    grads = trainer.gradient(params, unit_map, x[:64], y[:64])
    gw = {}
    with torch.no_grad():
        for lname in norms:
            acc = 0.0
            for path, entries in unit_map.items():
                for ln, axis in entries:
                    if ln != lname:
                        continue
                    gwp = grads[path].double() * params[path].double()
                    axes = tuple(i for i in range(gwp.dim()) if i != axis)
                    if axes:   # torch's sum over dim=() would reduce everything
                        gwp = gwp.sum(dim=axes)
                    acc = acc + gwp.abs()
            gw[lname] = acc
        stats: Dict[str, torch.Tensor] = {}
        cnn_apply(params, trainer.cfg, torch.as_tensor(x[:64], device=trainer.device), stats=stats)

    counts = space.unit_counts

    def scatter(local: torch.Tensor, lname: str) -> np.ndarray:
        full = np.full(counts[lname], -np.inf)
        full[np.asarray(index[lname], np.int64)] = local.detach().cpu().numpy().astype(np.float64)
        return full

    return {
        "weight_norms": {k: scatter(v, k) for k, v in norms.items()},
        "grads": {k: scatter(v, k) for k, v in gw.items()},
        "activations": {k: scatter(stats[k], k) for k in norms if k in stats},
    }
