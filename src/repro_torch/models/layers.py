"""Shared building blocks of the LLM substrate (port of ``repro/models/layers.py``).

Parameters are nested dicts of tensors.  Initializers draw from an explicit
``torch.Generator`` and allocate on its device; ``lead`` prepends stacking
axes (the scan-group axis) so a stacked parameter is drawn in place.  Given
``SHAPE_ONLY`` in place of a generator, every initializer returns a ``meta``
tensor of the same shape and dtype and draws nothing (``jax.eval_shape`` of
the init), so one code path builds both trees.  As in
the JAX package, parameters are float32 or bfloat16; ``rms_norm``,
``layer_norm`` and ``apply_rope`` compute in float32 and cast back to the
input's dtype.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = [
    "SHAPE_ONLY",
    "dense_init",
    "normal_init",
    "uniform_init",
    "rms_norm",
    "layer_norm",
    "softcap",
    "rotary_embedding",
    "apply_rope",
    "gelu",
    "silu",
]

_SQRT2 = math.sqrt(2.0)
_PHI_M2 = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))   # standard normal CDF at -2


class _ShapeOnly:
    """The stand-in for a generator that makes initializers draw nothing:
    its ``device`` is ``meta``."""

    device = torch.device("meta")

    def __repr__(self):
        return "SHAPE_ONLY"


SHAPE_ONLY = _ShapeOnly()


def _shape(lead: Sequence[int], in_dim: int, out_shape) -> Tuple[int, ...]:
    out = tuple(out_shape) if isinstance(out_shape, tuple) else (out_shape,)
    return (*lead, in_dim, *out)


def dense_init(gen: torch.Generator, in_dim: int, out_shape: Union[int, tuple],
               scale: Optional[float] = None, lead: Sequence[int] = (),
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init on [-2, 2] times ``scale`` (default
    ``1/sqrt(in_dim)``), shape ``(*lead, in_dim, *out_shape)``; drawn in
    float32 by inverting the normal CDF on a uniform sample, then cast to
    ``dtype`` (as the JAX init casts its float32 draw).  A stacked parameter
    is drawn one leading slice at a time, so no float32 copy of a whole
    stack is held (a bf16 32B model's FFN stack would take 33 GB in float32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    shape = _shape(lead, in_dim, out_shape)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if gen is SHAPE_ONLY:
        return out
    for sl in out.view(-1, *shape[len(lead):]):
        t = torch.empty(sl.shape, dtype=torch.float32, device=gen.device)
        t.uniform_(_PHI_M2, 1.0 - _PHI_M2, generator=gen)
        sl.copy_(t.mul_(2.0).sub_(1.0).erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0).mul_(scale))
    return out


def normal_init(gen: torch.Generator, shape: Sequence[int], std: float,
                dtype=torch.float32) -> torch.Tensor:
    if gen is SHAPE_ONLY:
        return torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    return t.normal_(0.0, std, generator=gen).to(dtype)


def uniform_init(gen: torch.Generator, shape: Sequence[int], low: float, high: float) -> torch.Tensor:
    """A float32 draw uniform on ``[low, high)``."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    return t if gen is SHAPE_ONLY else t.uniform_(low, high, generator=gen)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with (1+scale) parameterization (Gemma-style: init scale=0),
    computed in float32."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float = 10000.0):
    """Return (sin, cos) of shape [..., head_dim/2] for given positions."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; sin/cos: [..., seq, head_dim/2]
    (split-half rotation)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    sin = sin[..., :, None, :]
    cos = cos[..., :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
