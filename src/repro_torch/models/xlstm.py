"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and the sLSTM
variant (port of ``repro/models/xlstm.py``).

mLSTM: prefilled in its parallel form (the decay-masked quadratic form),
whole or in row blocks of ``spec.t_block`` rows when ``s`` is a multiple
of it, and decoded in its recurrent form with the O(1) state ``(C [dk, dv],
n [dk], m [])`` per head that the parallel form hands over at its end.
Both forms are plain products, as in the reference.

sLSTM: the gate-input-only (associative) variant of the reference.  Its
cell and normaliser are two linear recurrences with the same decay,
``c_t = f_t c_{t-1} + (i z)_t`` and ``n_t = f_t n_{t-1} + i_t``, which the
reference runs through ``jax.lax.associative_scan``.  Here both go through
one call of ``kernels.rg_lru_scan`` (``h_t = a_t h_{t-1} + x_t``), with
``x = [i z, i]`` and ``a = [f, f]`` side by side on the channel axis: the
CUDA kernel in float32 on the card (one launch a layer), its plain loop on
the CPU.  The sequential scan rounds differently from the reference's
tree-ordered one; tests/test_torch_xlstm.py measures and states the cost.

Prunable units: heads (all projections are head-partitioned).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..kernels.rg_lru_scan import rg_lru_scan
from .layers import dense_init, silu

__all__ = [
    "XLSTMSpec",
    "init_mlstm", "mlstm_fwd", "mlstm_decode", "init_mlstm_state",
    "init_slstm", "slstm_fwd", "slstm_decode", "init_slstm_state",
]

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class XLSTMSpec:
    d_model: int
    num_heads: int
    proj_factor: float = 2.0     # up-projection factor (mLSTM block)
    t_block: "int | None" = None  # row-block size for the parallel form

    @property
    def d_inner(self) -> int:
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.num_heads


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bse,ehk->bshk")`` as one matmul."""
    e, h, k = w.shape
    return (x @ w.reshape(e, h * k)).reshape(*x.shape[:-1], h, k)


# --------------------------- mLSTM ------------------------------------------

def init_mlstm(gen: torch.Generator, spec: XLSTMSpec, lead: Sequence[int] = (),
               dtype=torch.float32):
    D, DI, H, hd = spec.d_model, spec.d_inner, spec.num_heads, spec.head_dim
    dev = gen.device
    return {
        "w_up": dense_init(gen, D, DI, lead=lead, dtype=dtype),
        "w_gate": dense_init(gen, D, DI, lead=lead, dtype=dtype),
        "wq": dense_init(gen, DI, (H, hd), lead=lead, dtype=dtype),
        "wk": dense_init(gen, DI, (H, hd), lead=lead, dtype=dtype),
        "wv": dense_init(gen, DI, (H, hd), lead=lead, dtype=dtype),
        "w_i": dense_init(gen, DI, H, lead=lead, dtype=torch.float32),
        "w_f": dense_init(gen, DI, H, lead=lead, dtype=torch.float32),
        "b_f": torch.full((*lead, H), 3.0, dtype=torch.float32, device=dev),  # open forget gates
        "b_i": torch.zeros((*lead, H), dtype=torch.float32, device=dev),
        "w_down": dense_init(gen, DI, D, lead=lead, dtype=dtype),
    }


def _mlstm_qkvg(params, x: torch.Tensor):
    up = x @ params["w_up"]
    gate = silu(x @ params["w_gate"])
    q = _heads(up, params["wq"])
    k = _heads(up, params["wk"])
    v = _heads(up, params["wv"])
    i_pre = up.float() @ params["w_i"] + params["b_i"]
    f_pre = up.float() @ params["w_f"] + params["b_f"]
    return up, gate, q, k, v, i_pre, f_pre


def mlstm_fwd(params, spec: XLSTMSpec, x: torch.Tensor):
    """Parallel (quadratic) form, row-blocked when ``spec.t_block`` divides
    ``s`` (peak temporaries [b, h, tb, s] instead of [b, h, s, s]).
    x [b, s, d] -> (out [b, s, d], final recurrent state)."""
    b, s, _ = x.shape
    H, hd = spec.num_heads, spec.head_dim
    up, gate, q, k, v, i_pre, f_pre = _mlstm_qkvg(params, x)
    logf = F.logsigmoid(f_pre)                             # [b,s,h]
    Fc = torch.cumsum(logf, dim=1)                         # inclusive
    # head-major views for the products: [b, h, s(, hd)]
    Fh = Fc.transpose(1, 2)
    ih = i_pre.transpose(1, 2)
    kh = k.float().transpose(1, 2)
    vh = v.float().transpose(1, 2)
    j_pos = torch.arange(s, device=x.device)

    def rows(q_t, F_t, pos_t):
        """q_t [b,h,tb,hd], F_t [b,h,tb], pos_t [tb] -> h rows [b,h,tb,hd]."""
        Dm = F_t[..., :, None] - Fh[..., None, :] + ih[..., None, :]    # [b,h,tb,s]
        causal = pos_t[:, None] >= j_pos[None, :]
        Dm = Dm.masked_fill(~causal, _NEG)
        m = Dm.amax(dim=-1)
        W = torch.exp(Dm - m[..., None])
        qk = q_t.float() @ kh.transpose(-1, -2)
        S = (qk / math.sqrt(hd)) * W
        denom = torch.maximum(S.sum(dim=-1).abs(), torch.exp(-m))
        return (S @ vh) / denom[..., None]

    qh = q.transpose(1, 2)
    tb = spec.t_block
    if tb and s > tb and s % tb == 0:
        h = torch.cat([rows(qh[:, :, t0:t0 + tb], Fh[:, :, t0:t0 + tb], j_pos[t0:t0 + tb])
                       for t0 in range(0, s, tb)], dim=2)
    else:
        h = rows(qh, Fh, j_pos)
    h = h.transpose(1, 2).reshape(b, s, H * hd).to(x.dtype) * gate
    out = h @ params["w_down"]

    # final recurrent state for the decode handoff
    FL = Fc[:, -1, :]                                      # [b,h]
    scale_j = FL[:, None, :] - Fc + i_pre                  # [b,s,h]
    m_state = torch.clamp(scale_j.amax(dim=1), min=0.0)    # [b,h]
    w_j = torch.exp(scale_j - m_state[:, None, :]).transpose(1, 2)   # [b,h,s]
    wk = w_j[..., None] * kh                               # [b,h,s,hd]
    C = wk.transpose(-1, -2) @ vh                          # [b,h,hd,hd]
    n = wk.sum(dim=2)
    return out, {"C": C, "n": n, "m": m_state}


def init_mlstm_state(spec: XLSTMSpec, batch: int, device="cpu"):
    H, hd = spec.num_heads, spec.head_dim
    return {
        "C": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, H, hd), dtype=torch.float32, device=device),
        "m": torch.zeros((batch, H), dtype=torch.float32, device=device),
    }


def mlstm_decode(params, spec: XLSTMSpec, x: torch.Tensor, state):
    """Recurrent form, one token. x [b, 1, d]."""
    b = x.shape[0]
    H, hd = spec.num_heads, spec.head_dim
    up, gate, q, k, v, i_pre, f_pre = _mlstm_qkvg(params, x)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                    # [b,h,hd]
    i_pre, f_pre = i_pre[:, 0], f_pre[:, 0]                # [b,h]
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + state["m"], i_pre)
    f_s = torch.exp(logf + state["m"] - m_new)[..., None]
    i_s = torch.exp(i_pre - m_new)[..., None]
    kf, vf = k.float(), v.float()
    C = f_s[..., None] * state["C"] + i_s[..., None] * (kf[..., :, None] * vf[..., None, :])
    n = f_s * state["n"] + i_s * kf
    qf = q.float() / math.sqrt(hd)
    num = (qf[..., None, :] @ C)[..., 0, :]                # [b,h,hd]
    den = torch.maximum((qf * n).sum(dim=-1).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, 1, H * hd).to(x.dtype) * gate
    out = h @ params["w_down"]
    return out, {"C": C, "n": n, "m": m_new}


# --------------------------- sLSTM ------------------------------------------

def init_slstm(gen: torch.Generator, spec: XLSTMSpec, lead: Sequence[int] = (),
               dtype=torch.float32):
    D, DI = spec.d_model, spec.d_inner
    return {
        "w_up": dense_init(gen, D, DI, lead=lead, dtype=dtype),
        "w_z": dense_init(gen, DI, DI, lead=lead, dtype=dtype),
        "w_i": dense_init(gen, DI, DI, lead=lead, dtype=torch.float32),
        "w_f": dense_init(gen, DI, DI, lead=lead, dtype=torch.float32),
        "w_o": dense_init(gen, DI, DI, lead=lead, dtype=dtype),
        "b_f": torch.full((*lead, DI), 3.0, dtype=torch.float32, device=gen.device),
        "w_down": dense_init(gen, DI, D, lead=lead, dtype=dtype),
    }


def _slstm_pre(params, x: torch.Tensor):
    up = x @ params["w_up"]
    z = torch.tanh(up @ params["w_z"])
    i_pre = up.float() @ params["w_i"]
    f_pre = up.float() @ params["w_f"] + params["b_f"]
    o = torch.sigmoid(up @ params["w_o"])
    return z, i_pre, f_pre, o


def slstm_fwd(params, spec: XLSTMSpec, x: torch.Tensor):
    """Associative (gate-input-only) sLSTM. x [b, s, d]; the cell and the
    normaliser in one scan call over 2 * d_inner channels."""
    DI = spec.d_inner
    z, i_pre, f_pre, o = _slstm_pre(params, x)
    f = torch.exp(F.logsigmoid(f_pre))
    i = torch.exp(torch.clamp(i_pre, max=10.0))
    cn = rg_lru_scan(torch.cat([i * z.float(), i], dim=-1), torch.cat([f, f], dim=-1))
    c, n = cn[..., :DI], cn[..., DI:]
    h = o.float() * c / torch.clamp(n.abs(), min=1.0)
    out = h.to(x.dtype) @ params["w_down"]
    return out, {"c": c[:, -1].clone(), "n": n[:, -1].clone()}


def init_slstm_state(spec: XLSTMSpec, batch: int, device="cpu"):
    DI = spec.d_inner
    return {"c": torch.zeros((batch, DI), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, DI), dtype=torch.float32, device=device)}


def slstm_decode(params, spec: XLSTMSpec, x: torch.Tensor, state):
    z, i_pre, f_pre, o = _slstm_pre(params, x)
    f = torch.exp(F.logsigmoid(f_pre[:, 0]))
    i = torch.exp(torch.clamp(i_pre[:, 0], max=10.0))
    c = f * state["c"] + i * z[:, 0].float()
    n = f * state["n"] + i
    h = o[:, 0].float() * c / torch.clamp(n.abs(), min=1.0)
    out = (h.to(x.dtype) @ params["w_down"])[:, None, :]
    return out, {"c": c, "n": n}
