"""Flash attention: the CUDA kernel's wrapper and its plain PyTorch version.

Port of ``repro/kernels/flash_attention.py`` and ``ops.flash_attention``.
The function is

    o = softmax(softcap(q k^T / sqrt(d)) over the kept keys) v

with an optional causal mask, sliding window (key j kept for query i iff
``j > i - window``) and Gemma-2 logit softcap.  ``q`` is ``[b, s, h, d]``;
``k`` and ``v`` are ``[b, s, kv, d]`` with ``h % kv == 0``, and query head
``h`` reads kv head ``h // (h / kv)`` — the head order of the model's
``_repeat_kv`` — so MQA/GQA K/V are never repeated on the card.  Unlike the
TPU wrapper, any ``s`` is taken.

Mask value: the TPU kernel writes ``-1e30`` into masked scores and the JAX
model (``attention._mask_bias``) and ``ref.flash_attention_ref`` use
``finfo(float32).min``; the CUDA kernel gives a masked key probability
exactly 0.  All of them agree whenever each query row keeps at least one key,
since ``exp(masked - max)`` is then 0 in every form, and causal
self-attention always keeps key ``i`` for query ``i``.  (A row with no kept
key would average ``v`` under the references and come out 0 from the
kernel; the model never builds one.)

A CPU tensor runs the plain version (``flash_attention_plain``: repeat K/V,
then ``ref.flash_attention_ref``); a CUDA tensor launches
``csrc/flash_attention.cu`` (head dims 64, 128, 256, float32) or raises.
``LAUNCHES`` counts kernel launches, incremented only right after one.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from .ref import flash_attention_ref

__all__ = [
    "LAUNCHES",
    "HEAD_DIMS",
    "reset_launches",
    "flash_attention",
    "flash_attention_plain",
    "flash_attention_cuda",
    "repeat_kv",
    "smem_bytes",
]

NAME = "flash_attention"
LAUNCHES: Dict[str, int] = {NAME: 0}
HEAD_DIMS = (64, 128, 256)   # the kernel's template instances


def reset_launches() -> None:
    LAUNCHES[NAME] = 0


def repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    """``[b, t, kv, d] -> [b, t, kv * rep, d]``, head ``h`` from kv head
    ``h // rep`` (``repro/models/attention.py:_repeat_kv``)."""
    if rep == 1:
        return x
    b, t, kv, d = x.shape
    return x[:, :, :, None, :].expand(b, t, kv, rep, d).reshape(b, t, kv * rep, d)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    rep = q.shape[2] // k.shape[2]
    return flash_attention_ref(q, repeat_kv(k, rep), repeat_kv(v, rep),
                               causal=causal, window=window, softcap=softcap)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library(NAME)
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_f32.argtypes = [P, P, P, P, I, I, I, I, I, I, I, F, F, P]
        lib.flash_attention_f32.restype = I
        lib.flash_attention_smem_bytes.argtypes = [I]
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one kernel block at ``head_dim``."""
    return int(_lib().flash_attention_smem_bytes(head_dim))


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """Launch the kernel once on CUDA tensors (checked, made contiguous)."""
    dev = q.device
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{nm} must lie on {dev}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{nm} must be float32, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{nm} must be [b, s, heads, d], got {tuple(t.shape)}")
    b, s, h, d = q.shape
    kv = k.shape[2]
    if tuple(k.shape) != (b, s, kv, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q {tuple(q.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"{h} query heads are not a multiple of {kv} kv heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the flash kernel takes {HEAD_DIMS}")
    if h > 65535 or b > 65535:
        raise ValueError(f"b={b}, h={h}: the kernel's grid takes at most 65535 of each")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib().flash_attention_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, s, h, kv, d, int(bool(causal)), int(window or 0), float(softcap or 0.0),
        float(math.sqrt(d)), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    LAUNCHES[NAME] += 1
    return o


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Blocked online-softmax attention; ``k``/``v`` at their own kv head
    count.  CPU tensors take the plain version, CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got {q.device}")
    return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
