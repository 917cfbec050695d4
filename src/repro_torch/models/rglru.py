"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU (port of
``repro/models/rglru.py``, arXiv:2402.19427).

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t)          # recurrence gate
    i_t = sigmoid(W_x x_t)          # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the recurrence through ``kernels.rg_lru_scan`` (the CUDA kernel
on the card, its plain loop on the CPU) where the JAX package runs
``jax.lax.associative_scan``; both compute the same linear recurrence.
Decode carries the [b, dr] state one step in plain torch.  Gates are
block-diagonal over heads as in Griffin.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from ..kernels.rg_lru_scan import rg_lru_scan
from .layers import dense_init, gelu, normal_init, uniform_init

__all__ = ["RGLRUSpec", "init_rglru", "rglru_fwd", "rglru_decode", "init_rglru_state"]

_C = 8.0  # Griffin's fixed temperature on the recurrence gate


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    d_model: int
    d_rnn: int               # lru width
    num_heads: int           # block-diagonal gate heads
    conv_width: int = 4


def init_rglru(gen: torch.Generator, spec: RGLRUSpec, lead: Sequence[int] = (),
               dtype=torch.float32):
    D, R, H = spec.d_model, spec.d_rnn, spec.num_heads
    hw = R // H
    p = {
        "w_y": dense_init(gen, D, R, lead=lead, dtype=dtype),       # gate branch in
        "w_x": dense_init(gen, D, R, lead=lead, dtype=dtype),       # recurrent branch in
        "conv": normal_init(gen, (*lead, spec.conv_width, R), 0.02, dtype),
        "gate_a": normal_init(gen, (*lead, H, hw, hw), 1.0 / math.sqrt(hw), dtype),
        "gate_x": normal_init(gen, (*lead, H, hw, hw), 1.0 / math.sqrt(hw), dtype),
    }
    # Lambda so that a = exp(-c*softplus(L)) spreads over (0.9, 0.999)
    u = uniform_init(gen, (*lead, R), 0.9**2, 0.999**2)
    p["lam"] = torch.log(torch.exp(-torch.log(u) / (2 * _C)) - 1.0)   # kept f32
    p["w_out"] = dense_init(gen, R, D, lead=lead, dtype=dtype)
    return p


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq: x [b,s,r], kernel [w,r]."""
    w, s = kernel.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, w - 1, 0))
    return sum(xp[:, i : i + s, :] * kernel[i][None, None, :] for i in range(w))


def _gates(x: torch.Tensor, params, spec: RGLRUSpec):
    """Block-diagonal gate projections; x [.., s, r] -> (r_t, i_t)."""
    H = spec.num_heads
    xh = x.reshape(*x.shape[:-1], H, x.shape[-1] // H)
    r = torch.sigmoid(torch.einsum("...hi,hij->...hj", xh, params["gate_a"]))
    i = torch.sigmoid(torch.einsum("...hi,hij->...hj", xh, params["gate_x"]))
    return r.reshape(x.shape), i.reshape(x.shape)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _lru_coeffs(params, x_branch: torch.Tensor, spec: RGLRUSpec):
    r, i = _gates(x_branch, params, spec)
    log_a = -_C * _softplus(params["lam"]) * r.float()
    a = torch.exp(log_a)
    # sqrt(1 - a^2) with numerical floor
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * (i.float() * x_branch.float())
    return a, b


def init_rglru_state(spec: RGLRUSpec, batch: int, dtype=torch.float32, device="cpu"):
    return {
        "h": torch.zeros((batch, spec.d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, spec.conv_width - 1, spec.d_rnn), dtype=dtype, device=device),
    }


def rglru_fwd(params, spec: RGLRUSpec, x: torch.Tensor):
    """Full-sequence forward. x [b,s,d] -> ([b,s,d], final_state)."""
    y = gelu(x @ params["w_y"])
    xr = x @ params["w_x"]
    # the pre-conv tail feeds decode's conv window; copied so the state does
    # not keep the whole [b, s, r] activation alive
    conv_tail = xr[:, -(spec.conv_width - 1):, :].clone()
    xr = _causal_conv(xr, params["conv"])
    a, b = _lru_coeffs(params, xr, spec)
    h = rg_lru_scan(b, a)
    out = (h * y.float()).to(x.dtype) @ params["w_out"]
    return out, {"h": h[:, -1, :].clone(), "conv": conv_tail}


def rglru_decode(params, spec: RGLRUSpec, x: torch.Tensor, state):
    """One-token decode. x [b,1,d] -> ([b,1,d], new_state)."""
    y = gelu(x @ params["w_y"])
    xr = x @ params["w_x"]                                     # [b,1,r]
    window = torch.cat([state["conv"], xr], dim=1)             # [b,w,r]
    xc = torch.einsum("bwr,wr->br", window, params["conv"])[:, None, :]
    a, b = _lru_coeffs(params, xc, spec)
    h = a[:, 0] * state["h"] + b[:, 0]
    out = (h[:, None] * y.float()).to(x.dtype) @ params["w_out"]
    return out, {"h": h, "conv": window[:, 1:, :]}
