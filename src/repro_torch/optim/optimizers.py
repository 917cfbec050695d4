"""SGD with momentum over flat ``{path: tensor}`` dicts.

Port of the ``momentum`` optimizer of ``repro/optim/optimizers.py``:
``v <- beta * v + g`` and the update ``-lr * v`` is added to the params
(torch's SGD with dampening 0, written functionally because the masked
trainer gates every step by a validity mask and re-masks after training).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

__all__ = ["Optimizer", "momentum", "apply_updates"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tensors], Tensors]
    update: Callable[[Tensors, Tensors], Tuple[Tensors, Tensors]]


def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    return {k: params[k] + updates[k] for k in params}


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params: Tensors) -> Tensors:
        return {k: torch.zeros_like(v) for k, v in params.items()}

    def update(grads: Tensors, state: Tensors) -> Tuple[Tensors, Tensors]:
        new_v = {k: beta * state[k] + grads[k] for k in grads}
        return {k: -lr * v for k, v in new_v.items()}, new_v

    return Optimizer(init, update)
