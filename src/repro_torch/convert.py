"""Carry parameter dicts between numpy and the port's tensors.

``params_from_numpy`` turns a flat ``{path: array}`` dict — for example the
JAX package's ``init_cnn`` output passed through ``np.asarray`` — into
float32 tensors on ``device``, in the same HWIO layout, so the port can run
from the reference's exact init (``run_simulation(sim, base_params=...)``);
``params_to_numpy`` is the inverse.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(params: Mapping[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    return {
        k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
        for k, v in params.items()
    }


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
