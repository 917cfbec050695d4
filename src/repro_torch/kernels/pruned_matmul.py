"""Block-skip masked matmul: the CUDA kernel's wrapper, its autograd rule,
its plain PyTorch version, and the host-side block accounting.

Port of ``repro/kernels/pruned_matmul.py``.  The function is

    y = ((x * in_mask) @ w) * out_mask[None, :] * row_mask[:, None]

over a leading worker dimension ``B`` (the JAX package vmaps its kernel over
the resident ``[B, ...]`` stack; here the batch is written out and every row
carries its own masks).  Whole ``compute_blocks`` blocks whose units are all
pruned are skipped in all three dimensions, exactly as the TPU kernel skips
its grid steps: dead M/N output tiles write zeros, and the K loop walks a
compacted list of live K blocks built on the device (no host sync).

``pruned_matmul`` is the differentiable entry point.  A CPU tensor goes to
the plain version (``pruned_matmul_plain``); a CUDA tensor launches the
hand-written kernel (``csrc/pruned_matmul.cu``) or raises.  A ``meta``
tensor goes through the plain version too: shapes only, with its products
visible to ``FlopCounterMode``.  Its backward
pass reuses the same kernel through strides, with no materialised transpose:

    dX = K(g, wᵀ, out_mask, in_mask, row_mask)   blocks (bm, bk, bn)
    dW = K(xᵀ, g, row_mask, out_mask, in_mask)   blocks (bk, bn, bm)

so gradients are exactly zero on pruned units and backward FLOPs track
retention like the forward pass.

Each launch is planned on the host from shapes and strides alone
(``launch_plan``): the operand layout picks the kernel's template instance,
the block sizes pick its output tile (128 or 64 per side), and
``split_factor`` picks how many slices ``S`` split the live K blocks when
the output tiles alone cannot fill the card.  ``slice_bounds`` is the
kernel's rule for which live blocks each slice walks, and
``pruned_matmul_split_plain`` replays the whole split-K schedule in plain
torch (partials per slice, summed in slice order).

Both input modes of the Pallas kernel are ported: ``x`` and ``w`` float32,
or both bfloat16 (masks float32 either way).  In bf16 the products run on
the tensor cores (a product of two bf16 values is exact in float32), the
accumulators and the split-K workspace stay float32, and ``y`` is rounded to
bf16 once (the Pallas ``_finish`` casts its float32 accumulator to
``x.dtype``); the backward pass casts the cotangent to ``x.dtype`` and runs
dX and dW in the same mode, as ``_pm_bwd`` does.  Each mode has its own
instance per tile and layout, picked by the same rule on 16-byte copies (4
float32 or 8 bf16 elements).  The plain version computes bf16 as upcast
operands in float32, rounded once.  float16 and mixed dtypes are refused by
name.

``LAUNCHES`` counts the kernel launches per direction (forward, dX, dW)
and mode: ``pruned_matmul_fwd`` ... for float32, ``pruned_matmul_fwd_bf16``
... for bf16; each is incremented only right after its kernel was launched
(one count per product, the reduce pass of a split launch included).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "pruned_matmul",
    "pruned_matmul_plain",
    "pruned_matmul_cuda",
    "pruned_matmul_split_plain",
    "LaunchPlan",
    "launch_plan",
    "tile_shape",
    "split_factor",
    "slice_bounds",
    "instance_info",
    "keep_info",
    "check_blocks",
    "block_keep_count",
    "matmul_executed_blocks",
    "matmul_executed_flops",
]

FWD, DX, DW = "pruned_matmul_fwd", "pruned_matmul_bwd_dx", "pruned_matmul_bwd_dw"
LAUNCHES: Dict[str, int] = {k + mode: 0 for mode in ("", "_bf16") for k in (FWD, DX, DW)}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_pair(x: torch.Tensor, w: torch.Tensor, kinds) -> None:
    """``x`` and ``w`` share one dtype of ``kinds``."""
    if x.dtype not in kinds:
        raise ValueError(f"pruned_matmul: x must be one of {[str(k) for k in kinds]}, "
                         f"got {x.dtype}")
    if w.dtype != x.dtype:
        raise ValueError(f"pruned_matmul: w must have x's dtype {x.dtype}, got {w.dtype}")


# ---------------------------------------------------------------------------
# plain version (CPU tensors; the card's comparison baseline)
# ---------------------------------------------------------------------------

def pruned_matmul_plain(
    x: torch.Tensor, w: torch.Tensor, in_mask: torch.Tensor,
    out_mask: torch.Tensor, row_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``((x * in_mask) @ w) * out_mask * row_mask`` with autograd; 2-D or
    batched operands, masks ``[len]`` or ``[B, len]``.  bf16 operands are
    upcast, the function is computed in float32 and rounded to bf16 once
    (the gradients likewise, through the casts); float64 runs as it is."""
    _check_pair(x, w, (torch.float32, torch.bfloat16, torch.float64))
    dt = x.dtype
    if dt == torch.bfloat16:
        x, w = x.float(), w.float()
    y = (x * in_mask.unsqueeze(-2)) @ w
    y = y * out_mask.unsqueeze(-2)
    if row_mask is not None:
        y = y * row_mask.unsqueeze(-1)
    return y.to(dt)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library("pruned_matmul")
        P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        args = [
            P, L, L, L,            # x, strides b/m/k
            P, L, L, L,            # w, strides b/k/n
            P, L, P, L, P, L,      # in/out/row masks + batch strides
            P, P, P, P,            # m_keep, n_keep, k_live, k_count
            P, P,                  # y, workspace
            I, I, I, I, I, I, I,   # B M N K bm bn bk
            I, I, I,               # nMb nNb nKb
            I, I, I, I,            # layout tile_m tile_n split
            P,                     # stream
        ]
        for entry in ("pruned_matmul_f32", "pruned_matmul_bf16"):
            getattr(lib, entry).argtypes = args
            getattr(lib, entry).restype = I
        lib.pruned_matmul_instance_count.argtypes = []
        lib.pruned_matmul_instance_count.restype = I
        lib.pruned_matmul_instance_info.argtypes = [I, ctypes.c_char_p, I, ctypes.POINTER(I)]
        lib.pruned_matmul_instance_info.restype = I
        _LIB = lib
    return _LIB


def instance_info() -> Dict[str, Dict[str, int]]:
    """Every compiled kernel instance (and the reduce pass) with its
    registers, local bytes (spills and stack), static and dynamic shared
    bytes, as ``cudaFuncGetAttributes`` reports them on this card."""
    lib = _lib()
    out = {}
    for i in range(lib.pruned_matmul_instance_count()):
        name = ctypes.create_string_buffer(64)
        vals = (ctypes.c_int * 5)()
        rc = lib.pruned_matmul_instance_info(i, name, 64, vals)
        if rc != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {rc}")
        out[name.value.decode()] = dict(zip(
            ("registers", "local_bytes", "static_smem", "dynamic_smem", "max_threads"), vals))
    return out


# the kernel's output tiles are 128 or 64 wide per side
# (csrc/pruned_matmul.cu); 64 is the finest, so it sets the block grain
KERNEL_TILE = 64
WIDE_TILE = 128


def check_blocks(blocks: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """The kernel's output tiles (64 or 128 per side) must each lie inside
    one block of every dimension, and every block size is an output-tile
    dimension in one of the three directions, so each must be a multiple
    of 64."""
    bm, bn, bk = (int(b) for b in blocks)
    if any(b <= 0 or b % KERNEL_TILE for b in (bm, bn, bk)):
        raise ValueError(
            f"compute_blocks={tuple(blocks)}: the CUDA pruned_matmul kernel "
            f"needs every block size to be a positive multiple of its "
            f"{KERNEL_TILE}-wide tile, e.g. (128, 128, 128)"
        )
    return bm, bn, bk


KeepInfo = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def keep_info(mask: torch.Tensor, block: int) -> KeepInfo:
    """Per-row block keep flags of a ``[B, L]`` 0/1 mask, plus the compacted
    ascending list of live block ids and its length — all on the mask's
    device, computed with torch ops (no host sync).  A ragged last block
    counts only its real units (the zero padding adds nothing)."""
    B, L = mask.shape
    pad = -L % block
    mp = F.pad(mask, (0, pad)) if pad else mask
    flags = mp.reshape(B, -1, block).sum(-1) > 0
    nb = flags.shape[1]
    ar = torch.arange(nb, device=mask.device)
    live = torch.sort(torch.where(flags, ar, ar + nb), dim=1).values
    return (
        flags.to(torch.int32).contiguous(),
        live.to(torch.int32).contiguous(),
        flags.sum(1).to(torch.int32).contiguous(),
    )


# ---------------------------------------------------------------------------
# the launch plan (host, from shapes and strides alone: no device sync)
# ---------------------------------------------------------------------------

# operand layouts, one kernel template instance each (csrc/pruned_matmul.cu)
L_GENERIC, L_FWD, L_DX, L_DW = 0, 1, 2, 3
LAYOUTS = {L_GENERIC: "generic", L_FWD: "fwd", L_DX: "dx", L_DW: "dw"}
SPLIT_MIN_ROWS = 256   # a slice walks this many contraction rows or more, on average
SPLIT_MAX = 32         # at most this many slices (the workspace is S x the output)
# take the fewest slices within this factor of the best makespan: on the
# card, splitting conv4-6's forward for a ~10 % gain moved the one-step
# block_skip vs dense (cuDNN) parameter difference from 5.7e-5 to 9.7e-5
# of the 1e-4 bar (chip_smoke.py phase parity), for 0.3 ms per step
SPLIT_TOL = 1.25


class LaunchPlan(NamedTuple):
    layout: int
    tile_m: int
    tile_n: int
    split: int
    workspace_bytes: int

    @property
    def instance(self) -> str:
        return f"{self.tile_m}x{self.tile_n},{LAYOUTS[self.layout]}"


def tile_shape(M: int, N: int, bm: int, bn: int) -> Tuple[int, int]:
    """Output tile of one launch: 128 on a side whose block size is a
    multiple of 128 and whose extent exceeds 64, else 64, so a tile lies
    inside one block of each dimension."""
    tm = WIDE_TILE if bm % WIDE_TILE == 0 and M > KERNEL_TILE else KERNEL_TILE
    tn = WIDE_TILE if bn % WIDE_TILE == 0 and N > KERNEL_TILE else KERNEL_TILE
    return tm, tn


def split_factor(B: int, M: int, N: int, K: int, blocks: Tuple[int, int, int], sms: int) -> int:
    """Slices S of the contraction for one launch, from shapes alone.

    The model: each SM runs its blocks one after another, so a launch takes
    about ``ceil(tiles * S / sms)`` block times, and a block walks
    ``ceil(nKb / S)`` K blocks.  S is the fewest slices whose makespan
    ``ceil(tiles * S / sms) * ceil(nKb / S)`` is within ``SPLIT_TOL`` of the
    best, over S <= ``SPLIT_MAX`` with at least ``SPLIT_MIN_ROWS`` rows per
    slice on average.  So S = 1 where the output tiles already fill the
    SMs' waves, and S > 1 where few tiles walk a deep contraction."""
    bm, bn, bk = blocks
    tm, tn = tile_shape(M, N, bm, bn)
    tiles = B * -(-M // tm) * -(-N // tn)
    nkb = -(-K // bk)
    cap = max(1, min(SPLIT_MAX, nkb, K // SPLIT_MIN_ROWS))
    cost = [-(-tiles * S // sms) * -(-nkb // S) for S in range(1, cap + 1)]
    best = min(cost)
    return next(S for S, c in enumerate(cost, 1) if c <= best * SPLIT_TOL)


def slice_bounds(k_count: torch.Tensor, split: int) -> torch.Tensor:
    """``[B, split, 2]`` half-open ranges into each row's compacted live
    list: slice s of row b walks ``k_live[b, lo:hi]`` with
    ``lo = s * n // split``, ``hi = (s + 1) * n // split``, n = k_count[b]
    (the kernel's rule, evaluated on the device there)."""
    n = k_count.to(torch.int64).reshape(-1, 1)
    s = torch.arange(split + 1, device=k_count.device, dtype=torch.int64).reshape(1, -1)
    edges = s * n // split
    return torch.stack([edges[:, :-1], edges[:, 1:]], dim=-1)


def _aligned(strides: Tuple[int, ...], fast: int, extent: int, per_copy: int,
             ptr_ok: bool) -> bool:
    """Unit stride on dim ``fast``, the other strides and the extent along
    ``fast`` multiples of one 16-byte copy (``per_copy``: 4 float32 or 8
    bf16 elements), a 16-byte aligned pointer: the kernel's 16-byte
    cp.async copies are legal.  Stride 0 (a shared operand) counts as a
    multiple."""
    others = [st for d, st in enumerate(strides) if d != fast]
    return (strides[fast] == 1 and all(st % per_copy == 0 for st in others)
            and extent % per_copy == 0 and ptr_ok)


def _layout(M: int, K: int, N: int, xs: Tuple[int, ...], ws: Tuple[int, ...], per_copy: int,
            x_ok: bool, w_ok: bool) -> int:
    """The template instance for these operand strides, in either mode:
    forward (x k-fast, w n-fast), dX (x k-fast, w = w'^T k-fast), dW
    (x = x'^T m-fast, w n-fast), else the generic-stride one."""
    a_k, a_m = _aligned(xs, 2, K, per_copy, x_ok), _aligned(xs, 1, M, per_copy, x_ok)
    b_n, b_k = _aligned(ws, 2, N, per_copy, w_ok), _aligned(ws, 1, K, per_copy, w_ok)
    if a_k and b_n:
        return L_FWD
    if a_k and b_k:
        return L_DX
    if a_m and b_n:
        return L_DW
    return L_GENERIC


_SMS: Dict[int, int] = {}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


@functools.lru_cache(maxsize=4096)
def _plan(B: int, M: int, K: int, N: int, xs: Tuple[int, ...], ws: Tuple[int, ...],
          per_copy: int, x_ok: bool, w_ok: bool, blocks: Tuple[int, int, int],
          sms: int) -> LaunchPlan:
    bm, bn, _ = blocks
    tm, tn = tile_shape(M, N, bm, bn)
    S = split_factor(B, M, N, K, blocks, sms)
    ws_bytes = 4 * S * B * M * N if S > 1 else 0
    return LaunchPlan(_layout(M, K, N, xs, ws, per_copy, x_ok, w_ok), tm, tn, S, ws_bytes)


def launch_plan(x: torch.Tensor, w: torch.Tensor, blocks: Tuple[int, int, int],
                sms: Optional[int] = None) -> LaunchPlan:
    """Instance, tile and split of one launch on ``x [B, M, K]``,
    ``w [B, K, N]`` at this orientation's ``blocks``; ``sms`` defaults to
    the SM count of the operands' card.  A function of shapes, strides,
    element size and pointer alignment only, so it is cached on them (a
    training step asks for the same few dozen plans every step)."""
    B, M, K = x.shape
    return _plan(B, M, K, w.shape[2], x.stride(), w.stride(), 16 // x.element_size(),
                 x.data_ptr() % 16 == 0, w.data_ptr() % 16 == 0, tuple(blocks),
                 _sm_count(x.device) if sms is None else sms)


def pruned_matmul_split_plain(
    x: torch.Tensor, w: torch.Tensor, in_mask: torch.Tensor, out_mask: torch.Tensor,
    row_mask: torch.Tensor, blocks: Tuple[int, int, int], split: int,
) -> torch.Tensor:
    """The kernel's split-K schedule in plain torch, for ``[B, ...]``
    operands and ``[B, len]`` masks: slice s of row b sums
    ``(x * in_mask) @ w`` over its live K blocks (``slice_bounds``), the
    partials are added in slice order s = 0..S-1, then
    ``* out_mask * row_mask``, and dead M/N blocks are written as zeros."""
    bm, bn, bk = blocks
    B, M, K = x.shape
    N = w.shape[2]
    m_keep, _, _ = keep_info(row_mask, bm)
    n_keep, _, _ = keep_info(out_mask, bn)
    _, k_live, k_count = keep_info(in_mask, bk)
    bounds = slice_bounds(k_count, split)
    xm = x * in_mask.unsqueeze(-2)
    parts = torch.zeros((split, B, M, N), dtype=x.dtype, device=x.device)
    for b in range(B):
        for s in range(split):
            lo, hi = (int(v) for v in bounds[b, s])
            for kb in k_live[b, lo:hi].tolist():
                k0, k1 = kb * bk, min(kb * bk + bk, K)
                parts[s, b] += xm[b, :, k0:k1] @ w[b, k0:k1]
    y = parts[0]
    for s in range(1, split):
        y = y + parts[s]
    y = y * out_mask.unsqueeze(-2) * row_mask.unsqueeze(-1)
    live = (torch.repeat_interleave(m_keep.bool(), bm, dim=1)[:, :M].unsqueeze(-1)
            & torch.repeat_interleave(n_keep.bool(), bn, dim=1)[:, :N].unsqueeze(-2))
    return torch.where(live, y, torch.zeros_like(y))


def _check_operand(name: str, t: torch.Tensor, ndim: int, device, dtype=torch.float32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")


def pruned_matmul_cuda(
    x: torch.Tensor,                 # [B, M, K], any strides
    w: torch.Tensor,                 # [B, K, N], any strides
    in_mask: torch.Tensor,           # [B, K], unit stride along K
    out_mask: torch.Tensor,          # [B, N]
    row_mask: torch.Tensor,          # [B, M]
    blocks: Tuple[int, int, int],    # (bm, bn, bk) for THIS orientation
    keeps: Tuple[KeepInfo, KeepInfo, KeepInfo],   # row@bm, out@bn, in@bk
    counter: str = FWD,
) -> torch.Tensor:
    """Launch the block-skip kernel once (no autograd), with the instance,
    tile and split of ``launch_plan``.  ``keeps`` are the ``keep_info`` of
    (row_mask, bm), (out_mask, bn), (in_mask, bk)."""
    dev = x.device
    _check_pair(x, w, (torch.float32, torch.bfloat16))
    _check_operand("x", x, 3, dev, x.dtype)
    _check_operand("w", w, 3, dev, x.dtype)
    for nm, t in (("in_mask", in_mask), ("out_mask", out_mask), ("row_mask", row_mask)):
        _check_operand(nm, t, 2, dev)
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{nm} must have unit stride along its units")
    B, M, K = x.shape
    if w.shape[0] != B or w.shape[1] != K:
        raise ValueError(f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    N = w.shape[2]
    for nm, t, n in (("in_mask", in_mask, K), ("out_mask", out_mask, N),
                     ("row_mask", row_mask, M)):
        if tuple(t.shape) != (B, n):
            raise ValueError(f"{nm} {tuple(t.shape)} != {(B, n)}")
    if counter not in (FWD, DX, DW):
        raise ValueError(f"unknown launch counter {counter!r}")
    if B > 65535 or -(-M // KERNEL_TILE) * -(-N // KERNEL_TILE) >= 2**31:
        raise ValueError(f"B={B}, M={M}, N={N}: the kernel's grid takes B <= 65535 "
                         f"and fewer than 2**31 output tiles")
    bm, bn, bk = check_blocks(blocks)
    (m_keep, _, _), (n_keep, _, _), (_, k_live, k_count) = keeps
    nMb, nNb, nKb = -(-M // bm), -(-N // bn), -(-K // bk)
    if (tuple(m_keep.shape) != (B, nMb) or tuple(n_keep.shape) != (B, nNb)
            or tuple(k_live.shape) != (B, nKb) or tuple(k_count.shape) != (B,)):
        raise ValueError("keep flags do not match the operand shapes and blocks")
    for t in (m_keep, n_keep, k_live, k_count):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("keep flags must be contiguous int32 on the operands' device")
    plan = launch_plan(x, w, (bm, bn, bk))
    y = torch.empty((B, M, N), device=dev, dtype=x.dtype)
    ws = (torch.empty((plan.split, B, M, N), device=dev, dtype=torch.float32)
          if plan.split > 1 else None)
    bf16 = x.dtype == torch.bfloat16
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(_lib(), "pruned_matmul_bf16" if bf16 else "pruned_matmul_f32")(
        x.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
        w.data_ptr(), w.stride(0), w.stride(1), w.stride(2),
        in_mask.data_ptr(), in_mask.stride(0),
        out_mask.data_ptr(), out_mask.stride(0),
        row_mask.data_ptr(), row_mask.stride(0),
        m_keep.data_ptr(), n_keep.data_ptr(), k_live.data_ptr(), k_count.data_ptr(),
        y.data_ptr(), None if ws is None else ws.data_ptr(),
        B, M, N, K, bm, bn, bk, nMb, nNb, nKb,
        plan.layout, plan.tile_m, plan.tile_n, plan.split,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"pruned_matmul kernel launch failed: cudaError {rc}")
    LAUNCHES[counter + ("_bf16" if bf16 else "")] += 1
    return y


class _PrunedMatmul(torch.autograd.Function):
    """Forward and both gradients through the one CUDA kernel."""

    @staticmethod
    def forward(ctx, x, w, in_mask, out_mask, row_mask, blocks):
        bm, bn, bk = blocks
        k_row = keep_info(row_mask, bm)
        k_out = keep_info(out_mask, bn)
        k_in = keep_info(in_mask, bk)
        y = pruned_matmul_cuda(
            x, w, in_mask, out_mask, row_mask, blocks, (k_row, k_out, k_in), FWD
        )
        ctx.save_for_backward(x, w, in_mask, out_mask, row_mask)
        ctx.keeps = (k_row, k_out, k_in)
        ctx.blocks = blocks
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, in_mask, out_mask, row_mask = ctx.saved_tensors
        g = g.to(x.dtype)           # _pm_bwd: the cotangent in x's dtype
        k_row, k_out, k_in = ctx.keeps
        bm, bn, bk = ctx.blocks
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dX [B,M,K]: rows gated by row_mask, columns by in_mask, the
            # contraction over N skips pruned out_mask blocks
            dx = pruned_matmul_cuda(
                g, w.transpose(1, 2), out_mask, in_mask, row_mask,
                (bm, bk, bn), (k_row, k_in, k_out), DX,
            )
        if ctx.needs_input_grad[1]:
            # dW [B,K,N]: rows gated by in_mask, columns by out_mask, the
            # contraction over M skips dead row blocks
            dw = pruned_matmul_cuda(
                x.transpose(1, 2), g, row_mask, out_mask, in_mask,
                (bk, bn, bm), (k_in, k_out, k_row), DW,
            )
        return dx, dw, None, None, None, None


def _batched(t: torch.Tensor, ndim: int, B: int) -> torch.Tensor:
    """Give a shared (unbatched) operand a stride-0 batch dimension."""
    if t.dim() == ndim - 1:
        t = t.unsqueeze(0)
    if t.shape[0] != B:
        if t.shape[0] != 1:
            raise ValueError(f"batch {t.shape[0]} does not match {B}")
        t = t.expand((B,) + tuple(t.shape[1:]))
    return t


def pruned_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    in_mask: torch.Tensor,
    out_mask: torch.Tensor,
    row_mask: Optional[torch.Tensor] = None,
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Differentiable block-skip masked matmul,
    ``y = ((x * in_mask) @ w) * out_mask[None, :] * row_mask[:, None]``.

    ``x [M, K]`` or ``[B, M, K]``, ``w [K, N]`` or ``[B, K, N]``, both float32
    or both bfloat16 (``y`` in that dtype); masks are ``[len]`` (shared) or
    ``[B, len]`` (per row) 0/1 float32 vectors.
    Gradients flow to ``x`` and ``w`` only and are exactly zero on pruned
    units.  A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel, or raises on what it does not take (including block sizes that
    are not multiples of its 64-wide tile)."""
    if x.device.type in ("cpu", "meta"):
        return pruned_matmul_plain(x, w, in_mask, out_mask, row_mask)
    if x.device.type != "cuda":
        raise ValueError(f"pruned_matmul runs on CPU or CUDA tensors (or meta: shapes only), got {x.device}")
    blocks = check_blocks((block_m, block_n, block_k))
    squeeze = x.dim() == 2 and w.dim() == 2
    B = max(x.shape[0] if x.dim() == 3 else 1, w.shape[0] if w.dim() == 3 else 1)
    x3 = _batched(x, 3, B)
    w3 = _batched(w, 3, B)
    M, K, N = x3.shape[1], x3.shape[2], w3.shape[2]
    if row_mask is None:
        row_mask = torch.ones((M,), device=x.device, dtype=torch.float32)
    masks = []
    for m in (in_mask, out_mask, row_mask):
        m = _batched(m, 2, B)
        masks.append(m.contiguous() if m.shape[1] > 1 and m.stride(1) != 1 else m)
    for m, n, nm in zip(masks, (K, N, M), ("in_mask", "out_mask", "row_mask")):
        if m.shape[1] != n:
            raise ValueError(f"{nm} has {m.shape[1]} units, want {n}")
    y = _PrunedMatmul.apply(x3, w3, *masks, blocks)
    return y[0] if squeeze else y


# ---------------------------------------------------------------------------
# host-side block accounting (the FLOPs ledger's proxy)
# ---------------------------------------------------------------------------

def block_keep_count(mask: np.ndarray, block: int) -> int:
    """Number of blocks with >= 1 surviving unit, after padding to a multiple
    of ``block`` (the same flags the kernel reads)."""
    mask = np.asarray(mask)
    pad = -len(mask) % block
    if pad:
        mask = np.concatenate([mask, np.zeros(pad, mask.dtype)])
    return int((mask.reshape(-1, block).sum(axis=1) > 0).sum())


def matmul_executed_blocks(
    M: int, in_mask: np.ndarray, out_mask: np.ndarray, *,
    block_m: int = 128, block_n: int = 128, block_k: int = 128,
) -> int:
    """Block cells whose product actually executes (rows assumed all live)."""
    m_blocks = -(-M // block_m)
    return m_blocks * block_keep_count(in_mask, block_k) * block_keep_count(out_mask, block_n)


def matmul_executed_flops(
    M: int, in_mask: np.ndarray, out_mask: np.ndarray, *,
    block_m: int = 128, block_n: int = 128, block_k: int = 128,
) -> float:
    """Forward multiply-add FLOPs at block granularity:
    ``2 * M * K_exec * N_exec`` with K_exec/N_exec counted in kept blocks."""
    k_exec = block_keep_count(in_mask, block_k) * block_k
    n_exec = block_keep_count(out_mask, block_n) * block_n
    return 2.0 * M * k_exec * n_exec
