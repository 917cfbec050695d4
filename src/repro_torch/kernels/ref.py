"""Gather-based oracle of the block-skip kernel (port of ``repro/kernels/ref.py``)."""
from __future__ import annotations

import torch

__all__ = ["pruned_matmul_ref"]


def pruned_matmul_ref(
    x: torch.Tensor,          # [m, k_full]
    w: torch.Tensor,          # [k_full, n_full]
    in_idx: torch.Tensor,     # [k_sub] retained input-unit ids (sorted)
    out_idx: torch.Tensor,    # [n_sub] retained output-unit ids (sorted)
) -> torch.Tensor:
    """y = x[:, in_idx] @ w[in_idx][:, out_idx] — the sub-model's matmul
    against base-model weights."""
    return x.index_select(1, in_idx) @ w.index_select(0, in_idx).index_select(1, out_idx)
