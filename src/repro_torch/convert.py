"""Carry parameter trees between numpy and the port's tensors.

``params_from_numpy`` turns a flat ``{path: array}`` dict — for example the
JAX package's ``init_cnn`` output passed through ``np.asarray`` — into
float32 tensors on ``device``, in the same HWIO layout, so the port can run
from the reference's exact init (``run_simulation(sim, base_params=...)``);
``params_to_numpy`` is the inverse.

``tree_from_numpy`` / ``tree_to_numpy`` do the same for nested dicts and
lists (the LLM parameter and decode-state trees), keeping each leaf's dtype:
a test hands ``T.init_params(key, cfg)`` of the JAX package, leaf by leaf
through ``np.asarray``, to the port's ``models.transformer``, bf16 leaves
included, bit for bit (without importing ``ml_dtypes``, which the card's
machine lacks).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy", "tree_from_numpy", "tree_to_numpy"]


def params_from_numpy(params: Mapping[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    return {
        k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
        for k, v in params.items()
    }


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: JAX's leaves carry ml_dtypes'
        # type, which torch cannot read; its bits are the same as torch's
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.as_tensor(a, device=device)


def tree_from_numpy(tree: Any, device="cpu") -> Any:
    """Nested dicts / lists / tuples of arrays -> the same tree of tensors
    on ``device`` (each leaf copied, dtype kept; a leaf whose numpy dtype is
    named ``bfloat16`` becomes a ``torch.bfloat16`` tensor of the same
    bits)."""
    if isinstance(tree, Mapping):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    return _leaf_from_numpy(tree, device)


def tree_to_numpy(tree: Any) -> Any:
    """The inverse of ``tree_from_numpy`` except for bf16: numpy has no
    bfloat16, so a ``torch.bfloat16`` leaf comes back as float32, which
    holds every bf16 value exactly (``tree_from_numpy`` of it gives float32
    tensors; ``.to(torch.bfloat16)`` restores the bits).  Non-tensor leaves
    (a decode state's position) pass through."""
    if isinstance(tree, Mapping):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree
