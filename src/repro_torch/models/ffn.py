"""Feed-forward layers: gated (SwiGLU/GeGLU) and plain MLP (port of
``repro/models/ffn.py``).

The hidden dimension d_ff is AdaptCL's prunable unit axis: every hidden unit
owns one column of w_gate/w_up and one row of w_down.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from .layers import dense_init, gelu, silu

__all__ = ["FFNSpec", "init_ffn", "ffn_fwd"]


@dataclasses.dataclass(frozen=True)
class FFNSpec:
    d_model: int
    d_ff: int
    gated: bool = True          # SwiGLU/GeGLU vs plain 2-layer MLP
    activation: str = "silu"    # "silu" | "gelu"


def init_ffn(gen: torch.Generator, spec: FFNSpec, lead: Sequence[int] = (), dtype=torch.float32):
    p = {
        "w_up": dense_init(gen, spec.d_model, spec.d_ff, lead=lead, dtype=dtype),
        "w_down": dense_init(gen, spec.d_ff, spec.d_model, lead=lead, dtype=dtype),
    }
    if spec.gated:
        p["w_gate"] = dense_init(gen, spec.d_model, spec.d_ff, lead=lead, dtype=dtype)
    return p


def ffn_fwd(params, spec: FFNSpec, x: torch.Tensor) -> torch.Tensor:
    act = silu if spec.activation == "silu" else gelu
    up = x @ params["w_up"]
    if spec.gated:
        h = act(x @ params["w_gate"]) * up
    else:
        h = act(up)
    return h @ params["w_down"]
