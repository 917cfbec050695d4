"""Collaborative learning on the mesh: one worker per rank of a ``data``
axis.

Port of ``repro/core/collab.py``.  The simulator (``core.simulation``)
reproduces the paper's host-level protocol; this module runs the same
round on the collectives of a ``launch.mesh.FleetMesh``: each rank is one
worker holding its own shard of the batch, its sub-model is a nested CIG
unit mask in base coordinates, and by-worker aggregation is one masked sum
over the ranks,

    theta_g = (1/W) * psum_over_data(mask_w * theta_w),

closed by ``sharding.collectives.psum_fleet`` (one collective a round).
Pruned coordinates contribute exact zeros, Alg. 1 line 5 of the paper.
The module is model-agnostic: flat ``{path: tensor}`` params with a
``unit_map``, as in ``core.aggregation``.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.sharding.collectives import psum_fleet

from .aggregation import UnitMap, coordinate_mask
from .masks import GlobalIndex

__all__ = ["make_worker_masks", "collab_round", "local_sgd_steps", "linear_softmax_loss"]

Params = Dict[str, torch.Tensor]


def make_worker_masks(indices: Sequence[GlobalIndex], unit_map: UnitMap,
                      base_shapes: Mapping[str, tuple], device="cpu") -> Params:
    """Per-worker coordinate masks stacked: ``{path: [W, *shape]}`` float32."""
    return {
        path: torch.as_tensor(np.stack([
            coordinate_mask(path, idx, unit_map, base_shapes) for idx in indices
        ]).astype(np.float32), device=device)
        for path in base_shapes
    }


def linear_softmax_loss(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the linear model ``x @ w + b`` — the smallest
    flat-parameter model a round can carry."""
    logp = F.log_softmax(x @ params["w"] + params["b"], dim=-1)
    return -logp.gather(1, y.long().unsqueeze(1)).squeeze(1).mean()


def local_sgd_steps(loss_fn: Callable[[Params, torch.Tensor, torch.Tensor], torch.Tensor],
                    params: Params, x: torch.Tensor, y: torch.Tensor, *, lr: float,
                    steps: int, batch_size: int) -> Params:
    """``steps`` plain-SGD minibatch steps on this worker's shard; step
    ``i`` takes the batch at ``(i * batch_size) mod max(n - batch_size + 1,
    1)``, as the reference's ``dynamic_slice`` does."""
    n = x.shape[0]
    for i in range(steps):
        lo = (i * batch_size) % max(n - batch_size + 1, 1)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        keys = list(p)
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn(p, x[lo : lo + batch_size],
                                                y[lo : lo + batch_size]),
                                        [p[k] for k in keys])
        params = {k: params[k] - lr * g for k, g in zip(keys, grads)}
    return params


def collab_round(loss_fn: Callable, global_params: Params, masks: Params, x: torch.Tensor,
                 y: torch.Tensor, mesh, *, lr: float = 0.05, steps: int = 4,
                 batch_size: int = 32, axis: str = "data") -> Params:
    """One synchronous AdaptCL round over the ranks of ``mesh``'s ``axis``.

    This rank is one worker: ``masks`` holds its ``[1, *shape]`` mask rows
    and ``x``/``y`` its shard.  It takes its sub-model (the masked global),
    runs local SGD on the masked loss, and submits; the server's by-worker
    aggregation is the closing masked sum over the ranks divided by W.
    Returns the new global (base-coordinate) params, the same on every
    rank."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh axes {tuple(mesh.shape)} have no {axis!r} axis")
    W = mesh.shape[axis]
    mask_w = {k: m[0] for k, m in masks.items()}
    theta = {k: g * mask_w[k] for k, g in global_params.items()}

    def masked_loss(p, xb, yb):
        return loss_fn({k: w * mask_w[k] for k, w in p.items()}, xb, yb)

    theta = local_sgd_steps(masked_loss, theta, x, y, lr=lr, steps=steps, batch_size=batch_size)
    theta = {k: (w * mask_w[k]).detach() for k, w in theta.items()}
    return {k: v / W for k, v in psum_fleet(theta, mesh).items()}
