"""Mixture-of-Experts FFN with sort-based (dropping) dispatch (port of the
local path of ``repro/models/moe.py``).

Tokens are routed top-k by a float32 router, sorted by expert, packed into
a static ``[E, C, D]`` buffer of ``C = capacity(spec, T)`` slots an expert,
run through the experts as batched products (in chunks of experts whose
temporaries stay under ``EXPERT_CHUNK_BYTES``) and combined with the router
weights.  The semantics are the reference's exactly: the ``1e-9`` floor on
the renormalised gates, the overflow bucket ``E_here``, a stable sort by
expert, each assignment's slot from the exclusive cumsum of the counts,
``keep = pos < C`` (an expert's assignments past its capacity are dropped,
in token order), the sentinel row ``E_here * C``, and the combine weight
cast to the activation dtype before its product (in bf16 that rounding is
part of the result).

The combine uses no atomics: each token's ``k`` weighted expert rows are
added one after another in ascending expert order, the order in which the
reference's scatter-add meets them in the sorted list, so two runs on the
card agree bit for bit.  The expert products and the router are library
products (``torch.bmm`` / ``@``), as they are plain einsums outside any
Pallas kernel in the reference.

Only the local path is ported: ``moe_fwd`` always takes it, as the
reference does when no mesh has a ``model`` axis.  The expert-parallel
``shard_map`` path (``repro/models/moe.py:149-191``) waits for the mesh
specs of ROADMAP.md item A6.

Experts are a prunable AdaptCL unit (whole-expert pruning): a reconfigured
model has fewer experts, and the router's extra columns are ignored.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from .layers import dense_init, silu

__all__ = ["MoESpec", "init_moe", "moe_fwd", "capacity"]

# the experts' products run over chunks of experts whose [e, C, F]
# temporaries stay under this many bytes: a drop-free llama4-maverick layer
# (128 experts, C = 6208 slots at a 3104-token forward of batch 2, d_ff
# 8192) would otherwise hold 13 GB for each of them in bf16
EXPERT_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    num_experts: int
    num_experts_per_tok: int
    d_ff: int                      # per-expert hidden size
    capacity_factor: float = 1.25
    shared_expert: bool = False    # Llama-4 style always-on expert
    shared_d_ff: Optional[int] = None
    router_aux_weight: float = 0.01


def capacity(spec: MoESpec, num_tokens: int) -> int:
    c = int(
        math.ceil(num_tokens * spec.num_experts_per_tok * spec.capacity_factor / spec.num_experts)
    )
    return max(8, ((c + 7) // 8) * 8)


def init_moe(gen: torch.Generator, spec: MoESpec, lead: Sequence[int] = (),
             dtype=torch.float32):
    """The reference's tree: ``w_router`` [D, E] (always float32), expert
    weights ``w_gate``/``w_up`` [E, D, F] and ``w_down`` [E, F, D], each
    expert drawn at fan-in D (F for ``w_down``) as the reference draws them
    before its transpose; the shared expert's ``ws_*`` when
    ``spec.shared_expert``."""
    E, D, F = spec.num_experts, spec.d_model, spec.d_ff
    lead = tuple(lead)
    p = {
        "w_router": dense_init(gen, D, E, lead=lead, dtype=torch.float32),
        "w_gate": dense_init(gen, D, F, lead=(*lead, E), dtype=dtype),
        "w_up": dense_init(gen, D, F, lead=(*lead, E), dtype=dtype),
        "w_down": dense_init(gen, F, D, lead=(*lead, E), dtype=dtype),
    }
    if spec.shared_expert:
        SF = spec.shared_d_ff or F
        p["ws_gate"] = dense_init(gen, D, SF, lead=lead, dtype=dtype)
        p["ws_up"] = dense_init(gen, D, SF, lead=lead, dtype=dtype)
        p["ws_down"] = dense_init(gen, SF, D, lead=lead, dtype=dtype)
    return p


def _dispatch_compute_combine(params, spec: MoESpec, xf: torch.Tensor, probs: torch.Tensor,
                              e_lo: int, n_local: int):
    """Sort-based dispatch restricted to experts [e_lo, e_lo + n_local).

    xf: [T, D] tokens.  probs: [T, E_total] router probabilities.
    Returns (out [T, D], counts [E_total] routing counts before capacity).
    """
    T, D = xf.shape
    dt, dev = xf.dtype, xf.device
    k = spec.num_experts_per_tok
    E_here = n_local
    C = capacity(spec, T)

    gate, choice = torch.topk(probs, k, dim=-1)                # [T,k] global ids
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # a token's assignments in ascending expert order: the order in which the
    # reference's scatter-add meets them in the sorted list (slots and drops
    # do not depend on it: a token takes an expert at most once)
    choice, order = torch.sort(choice, dim=-1)
    gate = torch.gather(gate, -1, order)

    N = T * k
    flat_e = choice.reshape(N)
    ones = torch.ones_like(flat_e)
    counts_all = torch.zeros(probs.shape[1], dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, ones)

    local = (flat_e >= e_lo) & (flat_e < e_lo + E_here)
    loc_e = torch.where(local, flat_e - e_lo, torch.full_like(flat_e, E_here))  # overflow bucket
    sort_idx = torch.argsort(loc_e, stable=True)
    sorted_e = loc_e[sort_idx]
    counts = torch.zeros(E_here + 1, dtype=torch.long, device=dev).scatter_add_(0, loc_e, ones)
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_exp = torch.arange(N, device=dev) - offsets[sorted_e]
    keep = (pos_in_exp < C) & (sorted_e < E_here)
    token_of = sort_idx // k
    dest = torch.where(keep, sorted_e * C + torch.clamp(pos_in_exp, 0, C - 1),
                       torch.full_like(sorted_e, E_here * C))
    keep_x = keep[:, None].to(dt)
    # every dropped row lands on the sentinel row as zeros, kept rows on
    # their own slot
    buf = xf.new_zeros((E_here * C + 1, D))
    buf[dest] = xf[token_of] * keep_x
    buf = buf[:-1].view(E_here, C, D)

    out_buf = xf.new_zeros((E_here * C + 1, D))
    out_e = out_buf[:-1].view(E_here, C, D)
    F = params["w_gate"].shape[-1]
    step = max(1, EXPERT_CHUNK_BYTES // (C * F * xf.element_size()))
    for e0 in range(0, E_here, step):
        sl = slice(e0, e0 + step)
        h = silu(torch.bmm(buf[sl], params["w_gate"][sl])) * torch.bmm(buf[sl], params["w_up"][sl])
        # written into the buffer by a copy, not bmm(out=), which autograd
        # cannot record
        out_e[sl] = torch.bmm(h, params["w_down"][sl])

    gathered = out_buf[dest] * keep_x                          # [N, D], sorted order
    w = gate.reshape(N)[sort_idx].to(dt)
    contrib = torch.empty_like(gathered)
    contrib[sort_idx] = gathered * w[:, None]                  # back to token order
    contrib = contrib.view(T, k, D)
    out = xf.new_zeros((T, D))
    for j in range(k):
        out = out + contrib[:, j]
    return out, counts_all


def _moe_local(params, spec: MoESpec, x: torch.Tensor):
    b, s, D = x.shape
    T = b * s
    xf = x.reshape(T, D)
    E = params["w_gate"].shape[0]
    logits = xf.float() @ params["w_router"][:, :E]
    probs = torch.softmax(logits, dim=-1)
    out, counts = _dispatch_compute_combine(params, spec, xf, probs, 0, E)
    if spec.shared_expert:
        sh = silu(xf @ params["ws_gate"]) * (xf @ params["ws_up"])
        out = out + sh @ params["ws_down"]
    frac = counts.float() / max(T * spec.num_experts_per_tok, 1)
    aux = spec.router_aux_weight * E * torch.sum(frac * probs.mean(dim=0))
    return out.reshape(b, s, D), aux


def moe_fwd(params, spec: MoESpec, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [b, s, d], router load-balance aux loss scalar), on
    the local path."""
    return _moe_local(params, spec, x)
