"""Flash attention: the CUDA kernel's wrapper and its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py`` and ``ops.flash_attention``.
The function is

    o = softmax(softcap(q k^T / sqrt(d)) over the kept keys) v

with an optional causal mask, sliding window (key j kept for query i iff
``j > i - window``) and Gemma-2 logit softcap.  ``q`` is ``[b, s, h, d]``;
``k`` and ``v`` are ``[b, t, kv, d]`` with ``h % kv == 0``, and query head
``h`` reads kv head ``h // (h / kv)`` — the head order of the model's
``_repeat_kv`` — so MQA/GQA K/V are never repeated on the card.  Unlike the
TPU wrapper, any ``s`` is taken.

Cross mode: ``t != s`` is the model's cross-attention (Whisper's decoder
reading the encoder's ``t`` frames; ``repro/models/attention.py:117-157``
with ``xkv``): queries at positions ``arange(s)``, keys at ``arange(t)``,
every key kept.  It takes ``causal=False`` and ``window=None`` only; any
other combination with ``t != s`` raises ``ValueError`` (``check_cross``).

Mask value: the TPU kernel writes ``-1e30`` into masked scores and the JAX
model (``attention._mask_bias``) and ``ref.flash_attention_ref`` use
``finfo(float32).min``; the CUDA kernel gives a masked key probability
exactly 0.  All of them agree whenever each query row keeps at least one key,
since ``exp(masked - max)`` is then 0 in every form, and causal
self-attention always keeps key ``i`` for query ``i``.  (A row with no kept
key would average ``v`` under the references and come out 0 from the
kernel; the model never builds one.)

Both modes of the Pallas kernel are ported: q, k, v all float32, or all
bfloat16.  In bf16 scores, softmax, P and the accumulators stay float32,
and the output is rounded to bf16 once (the Pallas kernel's upcast at load
and cast at the store); the plain version does the same.  Any other dtype,
float16 included, and mixed dtypes are refused by name.

A CPU tensor runs the plain version (``flash_attention_plain``: repeat K/V,
then ``ref.flash_attention_ref``); a CUDA tensor launches
``csrc/flash_attention.cu`` (head dims 64, 128, 256) or raises.  A ``meta``
tensor (the dry-run's shape-only step, ``launch.dryrun``) goes through the
plain version too, forward and backward, bf16 included: it computes
nothing, and ``FlopCounterMode`` sees its products.
In float32 the kernel runs both products on the tensor cores in 3xTF32
(each operand split into two tf32 halves, three products summed in FP32),
which keeps it within the FP32 bar where one TF32 pass would not.  In bf16
Q K^T is one bf16 tensor-core pass (a product of two bf16 values is exact
in float32), and P V three: P split into three bf16 parts that sum to its
float32 value.  One block owns ``ROWS`` = 128 query rows that share their
K/V tiles: two query heads of one kv head at 64 positions when ``h / kv`` is
even, else 128 positions of one head (``heads_per_block``); it walks the
``BLOCK_K[dtype]``-key tiles in ``kv_tile_range`` (32 keys in float32, 64 in
bf16) and the grid runs the last query tiles first (``block_order``).  These
functions state the kernel's schedule in Python, for the tests; the CUDA
source computes the same.  ``LAUNCHES`` counts each mode's launches under
its own key (``flash_attention``, ``flash_attention_bf16``), each
incremented only right after one.

Gradients (the port's own: the Pallas kernel has no VJP, and the reference
trains through jnp attention): when autograd records the call,
``flash_attention`` goes through ``_FlashAttention``, which keeps q, k, v and
its output o.  Its backward computes ``D = rowsum(dO * O)``, ``dS = P (dP -
D)`` (times ``1 - tanh^2(s / c)`` under a softcap, then ``/ sqrt(d)``),
``dQ = dS K``, ``dK = dS^T Q``, ``dV = P^T dO``, with dK and dV summed over
each kv head's query heads: on a CPU tensor by the plain formulas
(``ref.flash_attention_bwd_ref``), on a CUDA tensor by
``csrc/flash_attention_bwd.cu`` (its own library, so the forward's source
and bits stay as they are), whose one entry point launches a dQ kernel, a
dK/dV kernel and, where the dK/dV walk is split, a reduce kernel, and
counts once in ``BWD_LAUNCHES``.  Every
float32 mode of the forward has a backward; the bf16 mode's raises
``NotImplementedError`` (ROADMAP.md, queue B).  The backward's kernels run
every product in 3xTF32 on the tensor cores; ``BWD_TUNE`` gives their rows
a block and a streamed tile per head dim, and ``bwd_q_tile_range``,
``bwd_n_split`` and ``bwd_dkv_walk`` state the dK/dV kernel's schedule in
Python, for the tests: where its key blocks do not fill the card, each
block's walk over (query head, live query tile) pairs is cut into
``n_split`` contiguous ranges, summed afterwards in split order.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = [
    "LAUNCHES",
    "MODES",
    "HEAD_DIMS",
    "reset_launches",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_cuda",
    "repeat_kv",
    "smem_bytes",
    "ROWS",
    "BLOCK_K",
    "heads_per_block",
    "block_order",
    "kv_tile_range",
    "check_cross",
    "BWD",
    "BWD_LAUNCHES",
    "flash_attention_bwd_plain",
    "flash_attention_bwd_cuda",
    "bwd_smem_bytes",
    "BWD_TUNE",
    "bwd_blocks",
    "bwd_q_tile_range",
    "bwd_n_split",
    "bwd_n_split_cuda",
    "bwd_dkv_walk",
]

NAME = "flash_attention"
# the kernel's element types: launch-count key and C entry point
MODES = {
    torch.float32: (NAME, "flash_attention_f32"),
    torch.bfloat16: ("flash_attention_bf16", "flash_attention_bf16"),
}
LAUNCHES: Dict[str, int] = {key: 0 for key, _ in MODES.values()}
BWD = "flash_attention_bwd"   # the backward's library and launch-count key
BWD_LAUNCHES: Dict[str, int] = {BWD: 0}
HEAD_DIMS = (64, 128, 256)   # the kernel's template instances
ROWS = 128                   # query rows (head, position) of one kernel block
# keys of one K/V tile, per mode
BLOCK_K = {torch.float32: 32, torch.bfloat16: 64}
# the backward's Tune<D> (csrc/flash_attention_bwd.cu): per head dim, (warps
# sharing 16 rows, rows of a streamed tile) of the dQ kernel, then of the
# dK/dV kernel; a block has BWD_WARPS warps
BWD_TUNE = {64: (1, 64, 1, 32), 128: (1, 32, 2, 32), 256: (2, 16, 4, 32)}
BWD_WARPS = 8
BWD_ROW_PAD = 64       # the lse / D scratch's rows: s rounded up to this
BWD_MAX_SPLIT = 16     # most ranges one dK/dV key block's walk is cut into


def reset_launches() -> None:
    for counts in (LAUNCHES, BWD_LAUNCHES):
        for key in counts:
            counts[key] = 0


def check_dtypes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q, k and v share one dtype of ``MODES``."""
    if q.dtype not in MODES:
        raise ValueError(f"flash_attention: q must be float32 or bfloat16, got {q.dtype}")
    for nm, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {nm} must have q's dtype {q.dtype}, got {t.dtype}")


def check_cross(s: int, t: int, causal: bool, window: Optional[int]) -> None:
    """``t`` keys for ``s`` queries: the causal mask and the window are
    self-attention's and need ``t == s``."""
    if t != s and (causal or window is not None):
        raise ValueError(f"flash_attention: cross mode (t={t} keys for s={s} queries) takes "
                         f"causal=False and window=None, got causal={causal}, window={window}")


def repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    """``[b, t, kv, d] -> [b, t, kv * rep, d]``, head ``h`` from kv head
    ``h // rep`` (``repro/models/attention.py:_repeat_kv``)."""
    if rep == 1:
        return x
    b, t, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, t, kv, rep, d).reshape(b, t, kv * rep, d)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    check_dtypes(q, k, v)
    check_cross(q.shape[1], k.shape[1], causal, window)
    rep = q.shape[2] // k.shape[2]
    return flash_attention_ref(q, repeat_kv(k, rep), repeat_kv(v, rep),
                               causal=causal, window=window, softcap=softcap)


def heads_per_block(h: int, kv: int) -> int:
    """Query heads that share one block's K/V tiles: two heads of the same
    kv head when ``h / kv`` is even, else one."""
    return 2 if (h // kv) % 2 == 0 else 1


def block_order(b: int, s: int, h: int, kv: int, rows: int = ROWS):
    """The kernel's grid in launch order: ``(first position, batch row,
    first head, heads)`` of each block.  The last query tiles (the longest
    causal rows) come first; within a tile, batch rows then head groups."""
    hpb = heads_per_block(h, kv)
    pos = rows // hpb
    nqt = -(-s // pos)
    return [(qt * pos, bb, hb * hpb, hpb)
            for qt in reversed(range(nqt)) for bb in range(b) for hb in range(h // hpb)]


def kv_tile_range(p0: int, positions: int, s: int, causal: bool, window: Optional[int],
                  block_k: int, t: Optional[int] = None):
    """``[begin, end)`` of the K/V tiles of ``t`` keys (default ``s``) that a
    block of query positions ``p0 .. p0 + positions - 1`` walks: none wholly
    above the causal diagonal of its newest row, none wholly out of the
    window of its oldest; in the cross mode (``t != s``) all of them."""
    t = s if t is None else t
    check_cross(s, t, causal, window)
    nkt = -(-t // block_k)
    end = min(nkt, (min(p0 + positions, s) - 1) // block_k + 1) if causal else nkt
    begin = 0
    if window:
        t = p0 - window - block_k + 1
        if t >= 0:
            begin = t // block_k + 1
    return begin, end


def bwd_blocks(d: int):
    """``(dq rows, key tile, dkv keys, query tile)`` of the backward's
    blocks at head dim ``d``: a block of ``BWD_WARPS`` warps owns 16 rows
    for every ``split`` of them."""
    q_split, q_tile, kv_split, kv_tile = BWD_TUNE[d]
    return 16 * BWD_WARPS // q_split, q_tile, 16 * BWD_WARPS // kv_split, kv_tile


def bwd_q_tile_range(j0: int, keys: int, s: int, causal: bool, window: Optional[int],
                     block_q: int, t: Optional[int] = None):
    """``[begin, end)`` of the query tiles of ``block_q`` rows that the dK/dV
    block of keys ``j0 .. j0 + keys - 1`` (of ``t``, default ``s``) walks:
    none wholly above the causal diagonal of its oldest key, none wholly past
    the window of its newest."""
    t = s if t is None else t
    check_cross(s, t, causal, window)
    nqt = -(-s // block_q)
    last = min(j0 + keys, t) - 1
    begin = min(nqt, j0 // block_q) if causal else 0
    end = min(nqt, (last + window - 1) // block_q + 1) if window else nqt
    return begin, end


def bwd_n_split(b: int, s: int, t: int, h: int, kv: int, d: int, sms: int) -> int:
    """The ranges each dK/dV key block's walk is cut into on a card of
    ``sms`` SMs: 1 where the ``ceil(t / keys) * kv * b`` blocks fill the
    SMs; else the count up to ``BWD_MAX_SPLIT`` (and the ``h / kv`` heads'
    query tiles) whose grid takes the fewest waves per split, the smallest
    on a tie.  The shape and the SM count decide it, not the mask."""
    _, _, keys, tile = bwd_blocks(d)
    base = -(-t // keys) * kv * b
    if base >= sms:
        return 1
    items = (h // kv) * -(-s // tile)
    best, best_waves = 1, 1
    for n in range(2, min(BWD_MAX_SPLIT, items) + 1):
        waves = -(-base * n // sms)
        if waves * best < best_waves * n:
            best, best_waves = n, waves
    return best


def bwd_dkv_walk(split: int, n_split: int, j0: int, s: int, h: int, kv: int, d: int,
                 causal: bool, window: Optional[int], t: Optional[int] = None):
    """The ``(query head within the group, query tile)`` pairs that split
    ``split`` of ``n_split`` of the dK/dV block at key ``j0`` walks, in
    order: a contiguous range of the block's pairs, head-major."""
    _, _, keys, tile = bwd_blocks(d)
    begin, end = bwd_q_tile_range(j0, keys, s, causal, window, tile, t)
    nq = max(0, end - begin)
    items = (h // kv) * nq
    lo, hi = items * split // n_split, items * (split + 1) // n_split
    return [(i // nq, begin + i % nq) for i in range(lo, hi)]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library(NAME)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for _, entry in MODES.values():
            getattr(lib, entry).argtypes = [P, P, P, P, I, I, I, I, I, I, I, I, F, F, P]
            getattr(lib, entry).restype = I
        lib.flash_attention_smem_bytes.argtypes = [I, I]
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def smem_bytes(head_dim: int, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one kernel block of mode ``dtype`` at
    ``head_dim``."""
    if dtype not in MODES:
        raise ValueError(f"flash_attention: no {dtype} mode")
    return int(_lib().flash_attention_smem_bytes(head_dim, int(dtype == torch.bfloat16)))


def _check_cuda(q, k, v, causal, window, softcap):
    """The kernels' argument checks; returns ``(b, s, t, h, kv, d)``."""
    dev = q.device
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{nm} must lie on {dev}, got {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{nm} must be [b, s, heads, d], got {tuple(t.shape)}")
    check_dtypes(q, k, v)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, t, kv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    check_cross(s, t, causal, window)
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the flash kernel takes {HEAD_DIMS}")
    if b * max(s, t) >= 2 ** 31:
        raise ValueError(f"b={b}, s={s}, t={t}: the kernel counts b * s and b * t positions in 32 bits")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    return b, s, t, h, kv, d


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel once on CUDA tensors (checked, made contiguous)."""
    b, s, t, h, kv, d = _check_cuda(q, k, v, causal, window, softcap)
    dev = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    key, entry = MODES[q.dtype]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(_lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, s, t, h, kv, d, int(bool(causal)), int(window or 0), float(softcap or 0.0),
        float(math.sqrt(d)), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    LAUNCHES[key] += 1
    return o


def check_bwd_dtype(q: torch.Tensor) -> None:
    if q.dtype != torch.float32:
        raise NotImplementedError(
            f"flash_attention: the backward runs in float32 only, got {q.dtype}: the bf16 "
            "backward is not ported yet (ROADMAP.md, queue B)")


def flash_attention_bwd_plain(q, k, v, o, do, *, causal: bool = True,
                              window: Optional[int] = None, softcap: Optional[float] = None):
    """(dq, dk, dv) of the float32 function: ``ref.flash_attention_bwd_ref``."""
    check_bwd_dtype(q)
    check_dtypes(q, k, v)
    check_cross(q.shape[1], k.shape[1], causal, window)
    return flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window, softcap=softcap)


def bwd_smem_bytes(head_dim: int):
    """Dynamic shared memory of one block of the backward's dQ and dK/dV
    kernels at ``head_dim``."""
    lib = _bwd_lib()
    return (int(lib.flash_attention_bwd_smem_bytes(head_dim, 0)),
            int(lib.flash_attention_bwd_smem_bytes(head_dim, 1)))


def bwd_n_split_cuda(b: int, s: int, t: int, h: int, kv: int, d: int, sms: int) -> int:
    """The kernel's own n_split for the shape (``bwd_n_split`` mirrors it)."""
    return int(_bwd_lib().flash_attention_bwd_n_split(b, s, t, h, kv, d, sms))


_BWD_LIB = None


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        from .build import load_library

        lib = load_library(BWD)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd_f32.argtypes = [P] * 11 + [I] * 8 + [F, F, I, I, P]
        lib.flash_attention_bwd_f32.restype = I
        lib.flash_attention_bwd_smem_bytes.argtypes = [I, I]
        lib.flash_attention_bwd_smem_bytes.restype = ctypes.c_longlong
        lib.flash_attention_bwd_n_split.argtypes = [I] * 7
        lib.flash_attention_bwd_n_split.restype = I
        _BWD_LIB = lib
    return _BWD_LIB


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels' float4
    loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_bwd_cuda(q, k, v, o, do, *, causal: bool = True,
                             window: Optional[int] = None, softcap: Optional[float] = None):
    """Launch the backward once on float32 CUDA tensors: the dQ kernel, the
    dK/dV kernel and, at ``n_split`` > 1, the reduce kernel; returns (dq, dk,
    dv)."""
    check_bwd_dtype(q)
    b, s, t, h, kv, d = _check_cuda(q, k, v, causal, window, softcap)
    for nm, x in (("o", o), ("do", do)):
        if x.device != q.device or tuple(x.shape) != tuple(q.shape) or x.dtype != q.dtype:
            raise ValueError(f"{nm} {tuple(x.shape)} {x.dtype} on {x.device} does not match q")
    q, k, v, o, do = (_aligned(x) for x in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    sp = -(-s // BWD_ROW_PAD) * BWD_ROW_PAD
    scratch = torch.empty((2, b, h, sp), dtype=torch.float32, device=q.device)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split = bwd_n_split(b, s, t, h, kv, d, sms)
    # the splits' partial dK, dV: [2, n_split, b, t, kv, d]
    part = torch.empty((2, n_split, b, t, kv, d) if n_split > 1 else (4,), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bwd_lib().flash_attention_bwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        part.data_ptr(), b, s, t, h, kv, d, int(bool(causal)), int(window or 0),
        float(softcap or 0.0), float(math.sqrt(d)), sms, n_split, stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention backward launch failed: cudaError {rc}")
    BWD_LAUNCHES[BWD] += 1
    return dq, dk, dv


def _forward(q, k, v, causal, window, softcap):
    if q.device.type in ("cpu", "meta"):
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors (or meta: shapes only), got {q.device}")
    return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)


class _FlashAttention(torch.autograd.Function):
    """Attention with its backward; each direction dispatches on the device
    (plain versions on the CPU, kernels on the card)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o = _forward(q, k, v, causal, window, softcap)
        ctx.save_for_backward(q, k, v, o)
        ctx.mode = {"causal": causal, "window": window, "softcap": softcap}
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        if q.device.type == "meta":
            # shapes only: the plain formulas in any mode, the bf16 one too
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, do, **ctx.mode)
        else:
            bwd = flash_attention_bwd_plain if q.device.type == "cpu" else flash_attention_bwd_cuda
            dq, dk, dv = bwd(q, k, v, o, do, **ctx.mode)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Blocked online-softmax attention; ``k``/``v`` at their own kv head
    count and, in the cross mode, their own length.  CPU tensors take the
    plain version, CUDA tensors the kernel.  Under autograd (an input that
    requires grad) the call records ``_FlashAttention``, whose backward
    dispatches the same way."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softcap)
    return _forward(q, k, v, causal, window, softcap)
