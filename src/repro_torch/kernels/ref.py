"""Plain PyTorch oracles of the kernels (port of ``repro/kernels/ref.py``).

Each takes float32 or bfloat16 operands; bf16 ones are upcast, the function
is computed in float32 and its result rounded to bf16 once, as the Pallas
kernels compute it."""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["pruned_matmul_ref", "flash_attention_ref", "rg_lru_ref"]


def pruned_matmul_ref(
    x: torch.Tensor,          # [m, k_full]
    w: torch.Tensor,          # [k_full, n_full]
    in_idx: torch.Tensor,     # [k_sub] retained input-unit ids (sorted)
    out_idx: torch.Tensor,    # [n_sub] retained output-unit ids (sorted)
) -> torch.Tensor:
    """y = x[:, in_idx] @ w[in_idx][:, out_idx] — the sub-model's matmul
    against base-model weights; bf16 operands are upcast, multiplied in
    float32 and the product rounded to bf16 once."""
    dt = x.dtype
    if dt == torch.bfloat16:
        x, w = x.float(), w.float()
    return (x.index_select(1, in_idx) @ w.index_select(0, in_idx).index_select(1, out_idx)).to(dt)


def flash_attention_ref(
    q: torch.Tensor,          # [b, s, h, d]
    k: torch.Tensor,          # [b, t, h, d]  (kv already repeated to h)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """softmax(softcap(q k^T / sqrt(d)), masked with finfo(f32).min) v,
    queries at positions ``arange(s)`` and keys at ``arange(t)``
    (``repro/models/attention.py:_mask_bias``)."""
    b, s, h, d = q.shape
    t = k.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(d)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    keep = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kp <= qp
    if window is not None:
        keep &= kp > qp - window
    scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, v.float())
    return out.to(q.dtype)


def rg_lru_ref(
    x: torch.Tensor,          # [b, s, r] gated inputs
    a: torch.Tensor,          # [b, s, r] per-step decay in (0, 1)
    h0: Optional[torch.Tensor] = None,   # [b, r]
) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + x_t, one step at a time (a rounded multiply,
    then a rounded add)."""
    b, s, r = x.shape
    h = (torch.zeros((b, r), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    a32, x32 = a.float(), x.float()
    out = torch.empty((b, s, r), dtype=torch.float32, device=x.device)
    for t in range(s):
        h = a32[:, t] * h + x32[:, t]
        out[:, t] = h
    return out.to(x.dtype)
