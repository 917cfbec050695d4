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
hand-written kernel (``csrc/pruned_matmul.cu``) or raises.  Its backward
pass reuses the same kernel through strides, with no materialised transpose:

    dX = K(g, wᵀ, out_mask, in_mask, row_mask)   blocks (bm, bk, bn)
    dW = K(xᵀ, g, row_mask, out_mask, in_mask)   blocks (bk, bn, bm)

so gradients are exactly zero on pruned units and backward FLOPs track
retention like the forward pass.

``LAUNCHES`` counts kernel launches per direction (forward, dX, dW); each
is incremented only right after its kernel was launched.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "LAUNCHES",
    "reset_launches",
    "pruned_matmul",
    "pruned_matmul_plain",
    "pruned_matmul_cuda",
    "keep_info",
    "check_blocks",
    "block_keep_count",
    "matmul_executed_blocks",
    "matmul_executed_flops",
]

FWD, DX, DW = "pruned_matmul_fwd", "pruned_matmul_bwd_dx", "pruned_matmul_bwd_dw"
LAUNCHES: Dict[str, int] = {FWD: 0, DX: 0, DW: 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain version (CPU tensors; the card's comparison baseline)
# ---------------------------------------------------------------------------

def pruned_matmul_plain(
    x: torch.Tensor, w: torch.Tensor, in_mask: torch.Tensor,
    out_mask: torch.Tensor, row_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``((x * in_mask) @ w) * out_mask * row_mask`` with autograd; 2-D or
    batched operands, masks ``[len]`` or ``[B, len]``."""
    y = (x * in_mask.unsqueeze(-2)) @ w
    y = y * out_mask.unsqueeze(-2)
    if row_mask is not None:
        y = y * row_mask.unsqueeze(-1)
    return y


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
        lib.pruned_matmul_f32.argtypes = [
            P, L, L, L,            # x, strides b/m/k
            P, L, L, L,            # w, strides b/k/n
            P, L, P, L, P, L,      # in/out/row masks + batch strides
            P, P, P, P,            # m_keep, n_keep, k_live, k_count
            P,                     # y
            I, I, I, I, I, I, I,   # B M N K bm bn bk
            I, I, I,               # nMb nNb nKb
            P,                     # stream
        ]
        lib.pruned_matmul_f32.restype = I
        _LIB = lib
    return _LIB


# the kernel's output tile (csrc/pruned_matmul.cu: TM = TN = 64)
KERNEL_TILE = 64


def check_blocks(blocks: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """The kernel's 64x64 output tiles must each lie inside one block of
    every dimension, and every block size is an output-tile dimension in
    one of the three directions, so each must be a multiple of 64."""
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


def _check_operand(name: str, t: torch.Tensor, ndim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
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
    """Launch the block-skip kernel once (no autograd).  ``keeps`` are the
    ``keep_info`` of (row_mask, bm), (out_mask, bn), (in_mask, bk)."""
    dev = x.device
    _check_operand("x", x, 3, dev)
    _check_operand("w", w, 3, dev)
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
    if counter not in LAUNCHES:
        raise ValueError(f"unknown launch counter {counter!r}")
    if B > 65535 or -(-M // KERNEL_TILE) > 65535:
        raise ValueError(f"B={B}, M={M}: the kernel's grid takes B <= 65535 and M <= 65535 * 64")
    bm, bn, bk = check_blocks(blocks)
    (m_keep, _, _), (n_keep, _, _), (_, k_live, k_count) = keeps
    nMb, nNb, nKb = -(-M // bm), -(-N // bn), -(-K // bk)
    if (tuple(m_keep.shape) != (B, nMb) or tuple(n_keep.shape) != (B, nNb)
            or tuple(k_live.shape) != (B, nKb) or tuple(k_count.shape) != (B,)):
        raise ValueError("keep flags do not match the operand shapes and blocks")
    for t in (m_keep, n_keep, k_live, k_count):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("keep flags must be contiguous int32 on the operands' device")
    y = torch.empty((B, M, N), device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().pruned_matmul_f32(
        x.data_ptr(), x.stride(0), x.stride(1), x.stride(2),
        w.data_ptr(), w.stride(0), w.stride(1), w.stride(2),
        in_mask.data_ptr(), in_mask.stride(0),
        out_mask.data_ptr(), out_mask.stride(0),
        row_mask.data_ptr(), row_mask.stride(0),
        m_keep.data_ptr(), n_keep.data_ptr(), k_live.data_ptr(), k_count.data_ptr(),
        y.data_ptr(),
        B, M, N, K, bm, bn, bk, nMb, nNb, nKb,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"pruned_matmul kernel launch failed: cudaError {rc}")
    LAUNCHES[counter] += 1
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

    ``x [M, K]`` or ``[B, M, K]``, ``w [K, N]`` or ``[B, K, N]``; masks are
    ``[len]`` (shared) or ``[B, len]`` (per row) 0/1 float32 vectors.
    Gradients flow to ``x`` and ``w`` only and are exactly zero on pruned
    units.  A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel, or raises on what it does not take (including block sizes that
    are not multiples of its 64-wide tile)."""
    if x.device.type == "cpu":
        return pruned_matmul_plain(x, w, in_mask, out_mask, row_mask)
    if x.device.type != "cuda":
        raise ValueError(f"pruned_matmul runs on CPU or CUDA tensors, got {x.device}")
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
