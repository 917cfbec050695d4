"""Optimizers over trees of tensors: SGD, momentum, AdamW.

Port of ``repro/optim/optimizers.py``, its optax-style API included:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``, the updates added to the params by ``apply_updates``.  A tree is
a tensor or nested dicts / lists / tuples of tensors: the simulator's flat
``{path: tensor}`` dicts and the LLM's parameter trees alike.  Every update
repeats the reference's operations in its order, each Python scalar taken
in float32 as JAX's weak types take it and AdamW's bias corrections as
float32 tensors (``1 - b ** t``), so both packages take the same steps from
the same gradients.  ``params`` may be left out of ``update`` where no
weight decay reads it (the simulator's momentum).

Each optimizer is one rule, ``begin(state) -> (leaf_, slots, finish)``:
``slots`` are the state's trees shaped like the params, ``leaf_(p, g,
*slot leaves)`` updates one leaf's slots in place and returns that leaf's
update, and ``finish(slots)`` is the next state.  ``update`` runs the rule
on copies of the slots; ``step_(params, grads, state) -> state`` runs it on
the slots themselves and adds each update to its param in place, so a step
holds no second copy of the params or the state, only a few temporaries of
one leaf (the LLM trainer, ``launch/train.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

__all__ = ["Optimizer", "sgd", "momentum", "adamw", "apply_updates", "tree_map", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    begin: Callable[[Any], Tuple[Callable[..., torch.Tensor], List[Any], Callable[[List[Any]], Any]]]

    def update(self, grads, state, params=None):
        """``(updates, state)``; ``state`` is left as it was."""
        leaf_, slots, finish = self.begin(state)
        slots = [tree_map(torch.clone, s) for s in slots]
        if params is None:
            params = tree_map(lambda g: None, grads)
        return tree_map(leaf_, params, grads, *slots), finish(slots)

    def step_(self, params, grads, state):
        """The same step, the params and the state updated in place."""
        leaf_, slots, finish = self.begin(state)
        tree_map(lambda p, g, *s: _add_(p, leaf_(p, g, *s)), params, grads, *slots)
        return finish(slots)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves in ``tree_map``'s order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _add_(p: torch.Tensor, u: torch.Tensor) -> None:
    """``p <- (p + u).to(p.dtype)`` in place."""
    if p.dtype == u.dtype:
        p.add_(u)
    else:
        p.copy_(p + u)


def _decayed(p, name: str) -> torch.Tensor:
    """The param that weight decay reads; ``update`` may have been given none."""
    if p is None:
        raise ValueError(f"{name} with weight_decay needs update(grads, state, params)")
    return p


def sgd(lr: float) -> Optimizer:
    return Optimizer(lambda p: (), lambda state: (lambda p, g: g * -lr, [], lambda s: state))


def momentum(lr: float, beta: float = 0.9, weight_decay: float = 0.0) -> Optimizer:
    def leaf_(p, g, v):
        if weight_decay:
            g = g + weight_decay * _decayed(p, "momentum")
        v.mul_(beta).add_(g)
        return v * -lr

    return Optimizer(lambda params: tree_map(torch.zeros_like, params),
                     lambda state: (leaf_, [state], lambda s: s[0]))


def adamw(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    state_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    """AdamW; ``state_dtype=torch.bfloat16`` keeps ``m`` and ``v`` in bf16
    (each rounded once a step, after its float32 update)."""

    def init(params):
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def corrections(t: torch.Tensor):
        tf = t.to(torch.float32)
        return tuple(1 - torch.pow(torch.tensor(b, dtype=torch.float32, device=t.device), tf)
                     for b in (b1, b2))

    def ema_(s: torch.Tensor, beta: float, x: torch.Tensor) -> None:
        """``s <- (beta * s + (1 - beta) * x)`` in float32, rounded once to
        ``s``'s dtype (a float32 ``s`` is its own ``.float()``: updated in
        place)."""
        s.copy_(s.float().mul_(beta).add_(x * (1 - beta)))

    def begin(state):
        t = state["t"] + 1
        bc1, bc2 = corrections(t)

        def leaf_(p, g, m, v) -> torch.Tensor:
            ema_(m, b1, g)
            ema_(v, b2, g * g)
            u = m.float() / bc1
            den = (v.float() / bc2).sqrt_().add_(eps)
            u.div_(den)
            del den
            if weight_decay:
                u.add_(_decayed(p, "adamw").float() * weight_decay)
            return u.mul_(-lr)

        return leaf_, [state["m"], state["v"]], lambda s: {"m": s[0], "v": s[1], "t": t}

    return Optimizer(init, begin)
