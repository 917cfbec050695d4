"""Mixture-of-Experts FFN with sort-based (dropping) dispatch, local and
expert-parallel (port of ``repro/models/moe.py``).

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

**Expert-parallel path.**  Under ``sharding.specs.current_mesh()`` with a
``model`` axis of ``n > 1`` ranks and ``E % n == 0`` (``E`` the spec's
``num_experts``), each rank holds only its ``E / n`` experts (``w_gate``,
``w_up``, ``w_down`` cut along the expert dimension), ``1 / n`` of the
shared expert (``ws_gate`` / ``ws_up`` columns, ``ws_down`` rows) and the
whole router: the reference's ``shard_map`` in-specs, which
``shard_tree(params, mesh, ep_pspec(E))`` cuts.  The tokens are those of
this rank's ``(pod,) data`` shard of the batch (all of them where the
batch does not divide, as decode at batch 1); each rank routes them over
all ``E`` experts, dispatches to its own ``[m E/n, (m+1) E/n)`` with the
capacity of its token count, and the partial outputs are added over the
model axis in rank order (``sharding.collectives.psum_fleet`` over the
mesh's model axis), so runs are bit-identical.  The output is gathered
back over the data axis, so ``moe_fwd`` takes and returns the whole batch
on every rank, as the reference's global arrays.  ``aux`` is the mean over the data and model
axes.  The path serves: it runs under ``no_grad`` and refuses autograd.
The local path stays for no mesh, ``n == 1`` and ``E % n != 0``.

Experts are a prunable AdaptCL unit (whole-expert pruning): a reconfigured
model has fewer experts, and the router's extra columns are ignored.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.sharding.specs import current_mesh, local_slice

from .layers import dense_init, silu

__all__ = ["MoESpec", "init_moe", "moe_fwd", "capacity", "ep_pspec", "RoutingSpy"]

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


def _n_model(mesh) -> int:
    return 0 if mesh is None else int(mesh.shape.get("model", 0))


def ep_pspec(num_experts: int):
    """The expert-parallel path's in-specs as a ``shard_tree`` rule: in
    every MoE block whose ``num_experts`` divide over the ``model`` axis,
    the experts cut along their expert dimension and the shared expert's
    hidden dimension cut ``n`` ways; every other leaf whole."""

    def rule(path: str, shape, mesh):
        parts = path.split("/")
        n = _n_model(mesh)
        if "moe" not in parts or n <= 1 or num_experts % n:
            return ()
        stk = 1 if "blocks" in parts else 0
        name = parts[-1]
        spec = [None] * len(shape)
        if name in ("w_gate", "w_up", "w_down"):
            spec[stk] = "model"
        elif name in ("ws_gate", "ws_up"):
            spec[stk + 1] = "model"
        elif name == "ws_down":
            spec[stk] = "model"
        return tuple(spec)

    return rule


def _moe_ep(params, spec: MoESpec, x: torch.Tensor, mesh, n: int):
    from repro_torch.sharding.collectives import all_gather_fleet, psum_fleet

    if torch.is_grad_enabled() and (x.requires_grad or params["w_gate"].requires_grad):
        raise NotImplementedError("the expert-parallel MoE path serves only (no_grad): "
                                  "training under a model mesh is ROADMAP.md item A6")
    E_loc = params["w_gate"].shape[0]
    E = spec.num_experts
    if not hasattr(mesh, "axes"):
        raise ValueError(f"{mesh!r} is a shape record: the expert-parallel path runs on the "
                         "ranks of launch.mesh.make_local_mesh")
    if E_loc * n != E:
        raise ValueError(f"expert-parallel moe_fwd takes this rank's {E // n} of {E} experts "
                         f"(shard_tree(params, mesh, ep_pspec({E}))), got {E_loc}")
    n_ba = mesh.shape["data"]
    ba = ("data",) if x.shape[0] % n_ba == 0 else ()   # decode at batch 1: replicate tokens
    xx = local_slice(x, ("data",), mesh) if ba else x
    b, s, D = xx.shape
    T = b * s
    xf = xx.reshape(T, D)
    logits = xf.float() @ params["w_router"][:, :E]
    probs = torch.softmax(logits, dim=-1)
    m = mesh.coords["model"]
    out, counts = _dispatch_compute_combine(params, spec, xf, probs, m * E_loc, E_loc)
    if spec.shared_expert:
        sh = silu(xf @ params["ws_gate"]) * (xf @ params["ws_up"])
        out = out + sh @ params["ws_down"]
    out = psum_fleet(out, mesh.axes["model"])
    frac = counts.float() / max(T * spec.num_experts_per_tok, 1)
    aux = spec.router_aux_weight * E * torch.sum(frac * probs.mean(dim=0))
    for ax in (*ba, "model"):
        if mesh.shape[ax] > 1:
            aux = psum_fleet(aux, mesh.axes[ax]) / mesh.shape[ax]
    out = out.reshape(b, s, D)
    if ba and n_ba > 1:
        out = all_gather_fleet(out, mesh.axes["data"])
    return out, aux


def moe_fwd(params, spec: MoESpec, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [b, s, d], router load-balance aux loss scalar):
    expert-parallel under a mesh whose ``model`` axis of ``n > 1`` ranks
    divides the experts, else local (module docstring)."""
    mesh = current_mesh()
    n = _n_model(mesh)
    if n <= 1 or spec.num_experts % n:
        return _moe_local(params, spec, x)
    return _moe_ep(params, spec, x, mesh, n)


class RoutingSpy:
    """Wraps ``_dispatch_compute_combine`` while ``installed()`` is open.
    Records each call (one an MoE layer, in order): its token count T,
    capacity C, the routed counts an expert and the router probabilities;
    ``choices()`` gives each token's expert set (sorted top-k) after the
    run, so a recorded run pays no device work of the spy's.  ``host_s`` is
    the spy's own host time inside the calls.

    With ``replay`` (one ``[T, k]`` table of expert sets a call) it also
    makes each call follow those decisions: on a row whose top-k set
    differs, the probabilities of the experts it would choose and those of
    the replayed set are swapped pairwise (largest with largest), so the
    row routes as replayed with gates that move by no more than the swapped
    gaps.  ``flipped`` marks those rows."""

    def __init__(self, replay=None):
        self.calls = []
        self.replay = replay
        self.host_s = 0.0

    def __call__(self, params, spec, xf, probs, e_lo, n_local):
        t0 = time.perf_counter()
        k = spec.num_experts_per_tok
        rec = {"T": xf.shape[0], "C": capacity(spec, xf.shape[0]), "k": k, "probs": probs}
        routed = probs
        if self.replay is not None:
            rec["choice"] = choice = torch.topk(probs, k, dim=-1).indices.sort(dim=-1).values
            want = self.replay[len(self.calls)]
            flipped = (choice != want).any(dim=-1)
            rows = flipped.nonzero().flatten().tolist()
            if rows:
                routed = probs.clone()
                for r in rows:
                    mine, theirs = set(choice[r].tolist()), set(want[r].tolist())
                    out_ = sorted(mine - theirs, key=lambda e: -float(probs[r, e]))
                    in_ = sorted(theirs - mine, key=lambda e: -float(probs[r, e]))
                    for i, j in zip(out_, in_):
                        routed[r, i], routed[r, j] = probs[r, j], probs[r, i]
                got = torch.topk(routed[rows], k, dim=-1).indices.sort(dim=-1).values
                if not torch.equal(got, want[rows]):
                    raise RuntimeError("moe replay: swapped rows do not route as replayed")
            rec["flipped"] = flipped
        self.host_s += time.perf_counter() - t0
        out, counts = self.real(params, spec, xf, routed, e_lo, n_local)
        rec["counts"] = counts
        self.calls.append(rec)
        return out, counts

    def choices(self):
        """Each call's expert sets, ``[T, k]`` sorted, from its probabilities."""
        for c in self.calls:
            if "choice" not in c:
                c["choice"] = torch.topk(c["probs"], c["k"], dim=-1).indices.sort(dim=-1).values
        return [c["choice"] for c in self.calls]

    @contextlib.contextmanager
    def installed(self):
        mod = sys.modules[__name__]
        self.real = mod._dispatch_compute_combine
        mod._dispatch_compute_combine = self
        try:
            yield self
        finally:
            mod._dispatch_compute_combine = self.real
