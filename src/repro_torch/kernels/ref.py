"""Plain PyTorch oracles of the kernels (port of ``repro/kernels/ref.py``).

Each forward takes float32 or bfloat16 operands; bf16 ones are upcast, the
function is computed in float32 and its result rounded to bf16 once, as the
Pallas kernels compute it.  The two backwards (``flash_attention_bwd_ref``,
``rg_lru_bwd_ref``) have no counterpart in the reference, whose Pallas
kernels carry no VJP: they are the explicit gradient formulas, in float32,
that the port's backward kernels compute and are held against."""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["pruned_matmul_ref", "flash_attention_ref", "rg_lru_ref",
           "flash_attention_bwd_ref", "rg_lru_bwd_ref"]


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


def flash_attention_bwd_ref(
    q: torch.Tensor,          # [b, s, h, d]
    k: torch.Tensor,          # [b, t, kv, d], h % kv == 0 (not repeated)
    v: torch.Tensor,
    o: torch.Tensor,          # [b, s, h, d] the forward's output
    do: torch.Tensor,         # [b, s, h, d] its incoming gradient
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
):
    """(dq, dk, dv) of ``flash_attention_ref`` with K/V at their own ``kv``
    heads, query head ``h`` reading kv head ``h // (h / kv)``, by the
    explicit formulas: ``P`` recomputed as the forward computes it,
    ``D = rowsum(dO * O)``, ``dS = P * (dO V^T - D)``, times ``1 -
    tanh^2(s / c)`` under a softcap, then ``/ sqrt(d)``; ``dQ = dS K``,
    ``dK = dS^T Q`` and ``dV = P^T dO``, summed over the query heads of each
    kv head."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    rep = h // kv
    q32, do32 = q.float(), do.float()
    kr = k.float().repeat_interleave(rep, dim=2)
    vr = v.float().repeat_interleave(rep, dim=2)
    s1 = torch.einsum("bshd,bthd->bhst", q32, kr) / math.sqrt(d)
    scores = s1
    if softcap is not None:
        th = torch.tanh(s1 / softcap)
        scores = softcap * th
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    keep = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kp <= qp
    if window is not None:
        keep &= kp > qp - window
    p = torch.softmax(scores.masked_fill(~keep, torch.finfo(torch.float32).min), dim=-1)
    dp = torch.einsum("bshd,bthd->bhst", do32, vr)
    dsum = (do32 * o.float()).sum(-1).transpose(1, 2)[..., None]        # [b, h, s, 1]
    ds = p * (dp - dsum)
    if softcap is not None:
        ds = ds * (1.0 - th * th)
    ds = ds / math.sqrt(d)
    dq = torch.einsum("bhst,bthd->bshd", ds, kr)
    dk = torch.einsum("bhst,bshd->bthd", ds, q32).reshape(b, t, kv, rep, d).sum(3)
    dv = torch.einsum("bhst,bshd->bthd", p, do32).reshape(b, t, kv, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rg_lru_bwd_ref(
    a: torch.Tensor,          # [b, s, r] the forward's decays
    h: torch.Tensor,          # [b, s, r] the forward's output
    h0: Optional[torch.Tensor],   # [b, r] its initial state (zeros when None)
    dh: torch.Tensor,         # [b, s, r] the incoming gradient
):
    """(dx, da, dh0) of ``rg_lru_ref``, walking the steps backwards:
    ``g = dh_t + a_{t+1} g`` (``g = dh_{s-1}`` at the last step), ``dx_t =
    g``, ``da_t = g h_{t-1}`` with ``h_{-1} = h0``, and ``dh0 = a_0 g``: a
    rounded multiply and a rounded add a step, the operations autograd
    applies to ``rg_lru_ref``, so the two agree bit for bit up to the sign
    of a zero."""
    b, s, r = a.shape
    a32, h32, dh32 = a.float(), h.float(), dh.float()
    hinit = (torch.zeros((b, r), dtype=torch.float32, device=a.device) if h0 is None
             else h0.float())
    dx = torch.empty((b, s, r), dtype=torch.float32, device=a.device)
    da = torch.empty_like(dx)
    g = dh32[:, s - 1]
    for t in range(s - 1, -1, -1):
        if t < s - 1:
            g = dh32[:, t] + a32[:, t + 1] * g
        dx[:, t] = g
        da[:, t] = g * (h32[:, t - 1] if t > 0 else hinit)
    return dx, da, a32[:, 0] * g
