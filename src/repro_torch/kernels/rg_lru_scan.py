"""RG-LRU linear recurrence: the CUDA kernel's wrapper and its plain version.

Port of ``repro/kernels/rg_lru_scan.py`` and ``ops.rg_lru_scan``:
``h_t = a_t * h_{t-1} + x_t`` over ``[b, s, r]`` inputs, from ``h0 [b, r]``
(zeros when ``None``, as ``ops.py`` does); returns every ``h_t``.  The
argument order is ``ops.rg_lru_scan(x, a, h0)``, not the ``pallas_call``'s
``(a, x, h0)``.

The TPU kernel closes each sequence block in log space,
``h = A * (h_in + cumsum(x / A))`` with ``A = cumprod(a)``, because the
TPU's vector unit does cumulative sums well and serial steps badly.  That
form is not carried over: on the card each channel's carry walks the steps
in order (``csrc/rg_lru_scan.cu``), and the log-space form would only add
the ``1 / A`` overflow bound that the TPU docstring warns about.  The kernel
does a rounded multiply and a rounded add per step, exactly as the plain
version, so the two agree bit for bit.  Each mode has its own schedule:

- float32: one warp walks ``F32_CHANNELS`` channels, two a lane, while a
  ring of ``F32_RING_STAGES`` stages of ``F32_STAGE_STEPS`` steps of ``a``
  and ``x`` streams into shared memory ahead of it by cp.async
  (``ring_schedule``).
- bfloat16: ``BF16_WALKERS`` warps walk ``BF16_CHANNELS`` channels, one a
  lane; a producer warp lands tiles of ``BF16_STAGE_STEPS`` steps in a ring
  of ``BF16_LOAD_STAGES`` slots by TMA, and each walked stage is staged in
  one of ``BF16_OUT_STAGES`` output slots and leaves as whole rows by a TMA
  store.

Both modes of the Pallas kernel are ported: ``x`` and ``a`` float32, or
both bfloat16 (``h0`` float32 either way, as the wrapper makes it).  A
bf16 element is read as float32, the carry and the arithmetic stay float32
and each ``h_t`` is rounded to bf16 once at its store, as the Pallas kernel
casts up at load and down at the store; the plain version does the same.
Any other dtype, float16 included, and mixed dtypes are refused by name.

A CPU tensor runs the plain version (``ref.rg_lru_ref``); a CUDA tensor
launches the kernel or raises.  ``LAUNCHES`` counts each mode's kernel
launches under its own key (``rg_lru_scan``, ``rg_lru_scan_bf16``).

Gradients (the port's own: the Pallas kernel has no VJP, and the reference
trains through ``associative_scan``): when autograd records the call,
``rg_lru_scan`` goes through ``_RGLRUScan``, which keeps ``a``, ``h0`` and
its output ``h`` and runs the reverse recurrence ``g_t = dh_t + a_{t+1}
g_{t+1}``, ``dx = g``, ``da_t = g_t h_{t-1}``, ``dh0 = a_0 g_0``: on a CPU
tensor by the plain backward (``ref.rg_lru_bwd_ref``), on a CUDA tensor by
the kernel ``rg_lru_scan_bwd_f32`` (counted in ``BWD_LAUNCHES``).
Both do the plain loop's rounded multiply and add, so they agree bit for
bit.  Only the float32 mode has a backward; the bf16 mode's raises
``NotImplementedError`` (ROADMAP.md, queue B).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from .ref import rg_lru_bwd_ref, rg_lru_ref

__all__ = ["LAUNCHES", "MODES", "F32_CHANNELS", "F32_STAGE_STEPS", "F32_RING_STAGES",
           "BF16_WALKERS", "BF16_CHANNELS", "BF16_STAGE_STEPS", "BF16_LOAD_STAGES",
           "BF16_OUT_STAGES", "BWD", "BWD_LAUNCHES", "reset_launches", "ring_schedule",
           "check_dtypes", "rg_lru_scan", "rg_lru_scan_plain", "rg_lru_scan_cuda",
           "rg_lru_scan_bwd_plain", "rg_lru_scan_bwd_cuda"]

NAME = "rg_lru_scan"
# the kernel's element types: launch-count key and C entry point
MODES = {torch.float32: (NAME, "rg_lru_scan_f32"),
         torch.bfloat16: ("rg_lru_scan_bf16", "rg_lru_scan_bf16")}
LAUNCHES: Dict[str, int] = {key: 0 for key, _ in MODES.values()}
BWD = "rg_lru_scan_bwd"   # launch-count key of the float32 backward kernel
BWD_LAUNCHES: Dict[str, int] = {BWD: 0}
# the float32 kernel (csrc/rg_lru_scan.cu, top namespace)
F32_CHANNELS = 64      # channels of one block (one warp, two a lane)
F32_STAGE_STEPS = 32   # steps of one ring stage
F32_RING_STAGES = 4    # stages of the ring: 128 steps, 64 KB of a and x a block
# the bf16 kernel (namespace bf16)
BF16_WALKERS = 2                      # walking warps of one block, one channel a lane
BF16_CHANNELS = 32 * BF16_WALKERS     # channels of one block
BF16_STAGE_STEPS = 64                 # steps of one ring slot and one output slot
BF16_LOAD_STAGES = 3                  # ring slots of a and x: 48 KB a block
BF16_OUT_STAGES = 2                   # output slots: 16 KB a block


def ring_schedule(s: int) -> List[Tuple[str, int]]:
    """One block's order of events over ``s`` steps, as the float32 kernel runs
    them: ``("issue", st)`` when the loads of stage ``st`` (steps
    ``st * F32_STAGE_STEPS`` on, the last stage short) go into ring slot
    ``st % F32_RING_STAGES``, ``("walk", st)`` when the warp walks it.  The
    first ``F32_RING_STAGES - 1`` stages are issued up front; before walking
    stage ``st`` the warp issues stage ``st + F32_RING_STAGES - 1`` into the
    slot that stage ``st - 1`` has just freed."""
    n = -(-s // F32_STAGE_STEPS)
    events = [("issue", st) for st in range(min(F32_RING_STAGES - 1, n))]
    for st in range(n):
        if st + F32_RING_STAGES - 1 < n:
            events.append(("issue", st + F32_RING_STAGES - 1))
        events.append(("walk", st))
    return events


def reset_launches() -> None:
    for counts in (LAUNCHES, BWD_LAUNCHES):
        for key in counts:
            counts[key] = 0


def check_dtypes(x: torch.Tensor, a: torch.Tensor, h0: Optional[torch.Tensor]) -> None:
    """``x`` and ``a`` one dtype of ``MODES``; ``h0`` float32 or that dtype."""
    if x.dtype not in MODES:
        raise ValueError(f"rg_lru_scan: x must be float32 or bfloat16, got {x.dtype}")
    if a.dtype != x.dtype:
        raise ValueError(f"rg_lru_scan: a must have x's dtype {x.dtype}, got {a.dtype}")
    if h0 is not None and h0.dtype not in (torch.float32, x.dtype):
        raise ValueError(f"rg_lru_scan: h0 must be float32 or {x.dtype}, got {h0.dtype}")


def rg_lru_scan_plain(x: torch.Tensor, a: torch.Tensor,
                      h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    check_dtypes(x, a, h0)
    return rg_lru_ref(x, a, h0)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library(NAME)
        P, I = ctypes.c_void_p, ctypes.c_int
        for _, entry in MODES.values():
            getattr(lib, entry).argtypes = [P, P, P, P, I, I, I, P]
            getattr(lib, entry).restype = I
        lib.rg_lru_scan_bwd_f32.argtypes = [P, P, P, P, P, P, P, I, I, I, P]
        lib.rg_lru_scan_bwd_f32.restype = I
        _LIB = lib
    return _LIB


def rg_lru_scan_cuda(x: torch.Tensor, a: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Launch the kernel once on CUDA tensors (checked, made contiguous; a
    bf16 ``h0`` is upcast to float32, which is exact)."""
    dev = x.device
    for nm, t in (("x", x), ("a", a), ("h0", h0)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{nm} must lie on {dev}, got {t.device}")
    check_dtypes(x, a, h0)
    if x.dim() != 3 or tuple(a.shape) != tuple(x.shape):
        raise ValueError(f"x {tuple(x.shape)} and a {tuple(a.shape)} must both be [b, s, r]")
    b, s, r = x.shape
    if tuple(h0.shape) != (b, r):
        raise ValueError(f"h0 {tuple(h0.shape)} != {(b, r)}")
    if b > 65535:
        raise ValueError(f"b={b}: the kernel's grid takes b <= 65535")
    x, a, h0 = x.contiguous(), a.contiguous(), h0.float().contiguous()
    out = torch.empty_like(x)
    key, entry = MODES[x.dtype]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(_lib(), entry)(x.data_ptr(), a.data_ptr(), h0.data_ptr(), out.data_ptr(),
                                b, s, r, stream)
    if rc != 0:
        raise RuntimeError(f"rg_lru_scan kernel launch failed: cudaError {rc}")
    LAUNCHES[key] += 1
    return out


def check_bwd_dtype(a: torch.Tensor) -> None:
    if a.dtype != torch.float32:
        raise NotImplementedError(
            f"rg_lru_scan: the backward runs in float32 only, got {a.dtype}: the bf16 "
            "backward is not ported yet (ROADMAP.md, queue B)")


def rg_lru_scan_bwd_plain(a: torch.Tensor, h: torch.Tensor, h0: Optional[torch.Tensor],
                          dh: torch.Tensor):
    """(dx, da, dh0) of the float32 scan: ``ref.rg_lru_bwd_ref``."""
    check_bwd_dtype(a)
    return rg_lru_bwd_ref(a, h, h0, dh)


def rg_lru_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor, dh: torch.Tensor):
    """Launch the backward kernel once on float32 CUDA tensors: (dx, da,
    dh0)."""
    check_bwd_dtype(a)
    dev = a.device
    for nm, t in (("a", a), ("h", h), ("h0", h0), ("dh", dh)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{nm} must lie on {dev}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"rg_lru_scan backward: {nm} must be float32, got {t.dtype}")
    b, s, r = a.shape
    if tuple(h.shape) != (b, s, r) or tuple(dh.shape) != (b, s, r) or tuple(h0.shape) != (b, r):
        raise ValueError(f"a {tuple(a.shape)}, h {tuple(h.shape)}, dh {tuple(dh.shape)} and "
                         f"h0 {tuple(h0.shape)} do not match")
    if b > 65535:
        raise ValueError(f"b={b}: the kernel's grid takes b <= 65535")
    a, h, h0, dh = a.contiguous(), h.contiguous(), h0.contiguous(), dh.contiguous()
    dx, da, dh0 = torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().rg_lru_scan_bwd_f32(dh.data_ptr(), a.data_ptr(), h.data_ptr(), h0.data_ptr(),
                                    dx.data_ptr(), da.data_ptr(), dh0.data_ptr(), b, s, r, stream)
    if rc != 0:
        raise RuntimeError(f"rg_lru_scan backward kernel launch failed: cudaError {rc}")
    BWD_LAUNCHES[BWD] += 1
    return dx, da, dh0


def _forward(x: torch.Tensor, a: torch.Tensor, h0: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type == "cpu":
        return rg_lru_scan_plain(x, a, h0)
    if x.device.type != "cuda":
        raise ValueError(f"rg_lru_scan runs on CPU or CUDA tensors, got {x.device}")
    if h0 is None:
        h0 = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32, device=x.device)
    return rg_lru_scan_cuda(x, a, h0)


class _RGLRUScan(torch.autograd.Function):
    """The scan with its backward; each direction dispatches on the device
    (plain versions on the CPU, kernels on the card)."""

    @staticmethod
    def forward(ctx, x, a, h0):
        h = _forward(x, a, h0)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h0, h = ctx.saved_tensors
        if a.device.type == "cpu":
            dx, da, dh0 = rg_lru_scan_bwd_plain(a, h, h0, dh)
        else:
            if h0 is None:
                h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32, device=a.device)
            dx, da, dh0 = rg_lru_scan_bwd_cuda(a, h, h0, dh)
        return dx, da, (dh0 if ctx.needs_input_grad[2] else None)


def rg_lru_scan(x: torch.Tensor, a: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + x_t``; CPU tensors take the plain version, CUDA
    tensors the kernel.  Under autograd (an input that requires grad) the
    call records ``_RGLRUScan``, whose backward dispatches the same way."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, a, h0)):
        return _RGLRUScan.apply(x, a, h0)
    return _forward(x, a, h0)
