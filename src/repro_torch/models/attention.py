"""Grouped-query attention (port of ``repro/models/attention.py``).

Supports GQA/MQA (num_kv_heads <= num_heads), rotary embeddings, qk-norm,
QKV bias, the Gemma-2 logit softcap, causal / sliding-window masks and
cross-attention (Whisper's decoder reading the encoder's output).  Prefill
(``attention_fwd``, self- or, with ``xkv``, cross-attention) goes through
``kernels.flash_attention``: the CUDA kernel on the card, its plain version
on the CPU, with K/V at their own head count and, across, their own length.
Single-token decode against the ring-buffer cache (``attention_decode``)
and against the encoder's static K/V (``cross_attention_decode``) is plain
torch, as the JAX package runs it outside any kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from ..kernels.flash_attention import flash_attention, repeat_kv
from .layers import apply_rope, dense_init, rms_norm, rotary_embedding, softcap

__all__ = ["AttnSpec", "init_attention", "attention_fwd", "init_cache", "attention_decode",
           "cross_attention_decode"]


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    logit_softcap: Optional[float] = None
    window: Optional[int] = None        # sliding-window size (None = full)
    causal: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True


def init_attention(gen: torch.Generator, spec: AttnSpec, lead: Sequence[int] = (),
                   dtype=torch.float32):
    H, KV, hd, D = spec.num_heads, spec.num_kv_heads, spec.head_dim, spec.d_model
    dev = gen.device
    p = {
        "wq": dense_init(gen, D, (H, hd), lead=lead, dtype=dtype),
        "wk": dense_init(gen, D, (KV, hd), lead=lead, dtype=dtype),
        "wv": dense_init(gen, D, (KV, hd), lead=lead, dtype=dtype),
        "wo": dense_init(gen, H * hd, D, scale=1.0 / math.sqrt(H * hd), lead=lead,
                         dtype=dtype).reshape(*lead, H, hd, D),
    }
    if spec.qkv_bias:
        p["bq"] = torch.zeros((*lead, H, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((*lead, KV, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((*lead, KV, hd), dtype=dtype, device=dev)
    if spec.qk_norm:
        p["q_norm"] = torch.zeros((*lead, hd), dtype=dtype, device=dev)
        p["k_norm"] = torch.zeros((*lead, hd), dtype=dtype, device=dev)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _project_qkv(params, spec: AttnSpec, x: torch.Tensor, xkv: torch.Tensor,
                 q_positions: torch.Tensor, kv_positions: torch.Tensor):
    q = _proj(x, params["wq"])
    k = _proj(xkv, params["wk"])
    v = _proj(xkv, params["wv"])
    if spec.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if spec.use_rope:
        sin_q, cos_q = rotary_embedding(q_positions, spec.head_dim, spec.rope_theta)
        sin_k, cos_k = ((sin_q, cos_q) if kv_positions is q_positions
                        else rotary_embedding(kv_positions, spec.head_dim, spec.rope_theta))
        q = apply_rope(q, sin_q, cos_q)
        k = apply_rope(k, sin_k, cos_k)
    return q, k, v


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")`` as one matmul."""
    h, k, d = wo.shape
    return o.reshape(*o.shape[:-2], h * k) @ wo.reshape(h * k, d)


def attention_fwd(params, spec: AttnSpec, x: torch.Tensor, *, xkv: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (prefill): self-attention over ``x``, or with
    ``xkv [b, t, d]`` cross-attention of ``x``'s queries (positions
    ``arange(s)``) to ``xkv``'s keys (positions ``arange(t)``), as the
    reference's ``attention_fwd(xkv=...)``, which its decoder calls with a
    non-causal, windowless spec.  Returns (output [b, s, d], (k, v)): the
    raw post-rope K/V at ``num_kv_heads``, reusable by the decode cache."""
    q_pos = torch.arange(x.shape[1], device=x.device)
    if xkv is None:
        xkv, kv_pos = x, q_pos
    else:
        kv_pos = torch.arange(xkv.shape[1], device=x.device)
    q, k, v = _project_qkv(params, spec, x, xkv, q_pos, kv_pos)
    o = flash_attention(q, k, v, causal=spec.causal, window=spec.window,
                        softcap=spec.logit_softcap)
    return _out_proj(o.to(x.dtype), params["wo"]), (k, v)


def init_cache(spec: AttnSpec, batch: int, max_len: int, dtype=torch.float32, device="cpu"):
    """Ring-buffer KV cache; windowed layers hold ``min(max_len, window)``."""
    if spec.window is not None:
        max_len = min(max_len, spec.window)
    shape = (batch, max_len, spec.num_kv_heads, spec.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # absolute position of each slot's token; -1 = empty
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32, device=device),
    }


def attention_decode(params, spec: AttnSpec, x: torch.Tensor, cache, position: int):
    """One-token decode, ``x [b, 1, d]`` at absolute ``position``.  Writes
    the new K/V into slot ``position % L`` of ``cache`` in place (the JAX
    version returns a new cache) and returns (out [b, 1, d], cache)."""
    q_pos = torch.tensor([position], device=x.device)
    q, k_new, v_new = _project_qkv(params, spec, x, x, q_pos, q_pos)
    L = cache["k"].shape[1]
    slot = position % L
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["pos"][:, slot] = position
    pos = cache["pos"]
    keep = (pos >= 0) & (pos <= position)
    if spec.window is not None:
        keep &= pos > position - spec.window
    neg = torch.finfo(torch.float32).min
    bias = torch.where(keep, 0.0, neg)                         # [b, L]
    rep = spec.num_heads // spec.num_kv_heads
    kr = repeat_kv(cache["k"].float(), rep)
    vr = repeat_kv(cache["v"].float(), rep)
    scores = torch.einsum("bshk,bthk->bhst", q.float(), kr) / math.sqrt(spec.head_dim)
    scores = softcap(scores, spec.logit_softcap)
    scores = scores + bias[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthk->bshk", probs, vr)
    return _out_proj(out.to(x.dtype), params["wo"]), cache


def cross_attention_decode(params, spec: AttnSpec, x: torch.Tensor, enc_k: torch.Tensor,
                           enc_v: torch.Tensor) -> torch.Tensor:
    """Decode-time cross-attention of ``x [b, 1, d]`` to the encoder's static
    K/V ``[b, t, kv, hd]`` (no cache update).  As the reference: the query
    takes its bias and ``q_norm`` but no rope; no softcap and no mask."""
    q = _proj(x, params["wq"])
    if spec.qkv_bias:
        q = q + params["bq"]
    if spec.qk_norm:
        q = rms_norm(q, params["q_norm"])
    rep = spec.num_heads // spec.num_kv_heads
    kr = repeat_kv(enc_k.float(), rep)
    vr = repeat_kv(enc_v.float(), rep)
    scores = torch.einsum("bshk,bthk->bhst", q.float(), kr) / math.sqrt(spec.head_dim)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthk->bshk", probs, vr)
    return _out_proj(out.to(x.dtype), params["wo"])
