"""The backward passes of the port's flash-attention and RG-LRU scan.

The reference has no backward for either Pallas kernel (it trains through
jnp), so the port's plain backwards (``kernels/ref.py``:
``flash_attention_bwd_ref`` and ``rg_lru_bwd_ref``, explicit formulas) are
held here against autograd of the plain forwards (``ref.flash_attention_ref``
on repeated K/V, ``ref.rg_lru_ref``) in every float32 mode: causal, sliding
window, softcap, GQA/MQA, the cross mode, head dims 64 / 128 / 256, ragged
lengths.  Bars: attention within ``BWD_TOL`` = 1e-5 of the largest
max|autograd| of dq, dk, dv (measured up to 4e-7: the same float32
arithmetic in another order); the scan bit for bit, up to the sign of a
zero (``da_0 = g_0 * 0`` with no initial state: autograd accumulates its
slices onto +0).

``flash_attention`` and ``rg_lru_scan`` under autograd record
``_FlashAttention`` / ``_RGLRUScan``, which run these plain backwards on the
CPU; the bf16 modes' backwards raise ``NotImplementedError``.  Tests marked
``cuda`` hold the backward kernels against the plain backwards on the card
(this file imports no JAX, so ``python -m pytest -q -m cuda
tests/test_torch_train_kernels.py`` runs there) and skip elsewhere.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import rg_lru_scan as rg_mod
from repro_torch.kernels.flash_attention import flash_attention, repeat_kv
from repro_torch.kernels.ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
    rg_lru_bwd_ref,
    rg_lru_ref,
)
from repro_torch.kernels.rg_lru_scan import rg_lru_scan

BWD_TOL = 1e-5
# the kernel against the plain backward on the card: FP32 FFMA against
# float32 einsums in another order, and P recomputed from the row's
# log-sum-exp instead of softmax's max and sum
CUDA_BWD_TOL = 1e-4


def _qkv(seed, b, s, t, h, kv, d, device="cpu"):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device)
               for shape in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d)))
    do = torch.as_tensor(rng.standard_normal((b, s, h, d)).astype(np.float32), device=device)
    return q, k, v, do


def _autograd(q, k, v, do, kw):
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    o = flash_attention_ref(q, repeat_kv(k, rep), repeat_kv(v, rep), **kw)
    return o.detach(), torch.autograd.grad(o, (q, k, v), do)


def _close(got, ref, tol):
    """Each of dq, dk, dv within ``tol`` of the largest max|ref| of the three
    (at one query, dq and dk are float noise around an exact 0)."""
    top = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= tol * top


# (b, s, t, h, kv, d, kw): t != s is the cross mode
FLASH_CASES = [
    (2, 40, 40, 4, 4, 64, {}),
    (1, 50, 50, 4, 1, 64, {"window": 7}),
    (2, 37, 37, 8, 2, 64, {"softcap": 20.0}),
    (1, 45, 45, 4, 2, 128, {"window": 16, "softcap": 50.0}),
    (1, 33, 33, 2, 1, 256, {}),
    (1, 30, 30, 3, 1, 64, {"causal": False}),
    (1, 29, 29, 2, 2, 64, {"causal": False, "window": 5}),
    (2, 20, 13, 4, 4, 64, {"causal": False}),
    (1, 9, 31, 6, 2, 128, {"causal": False}),
    (2, 1, 1, 2, 1, 64, {}),
]


@pytest.mark.parametrize("b,s,t,h,kv,d,kw", FLASH_CASES)
def test_flash_plain_backward_matches_autograd(b, s, t, h, kv, d, kw):
    q, k, v, do = _qkv(s + t + h, b, s, t, h, kv, d)
    o, ref = _autograd(q, k, v, do, kw)
    _close(flash_attention_bwd_ref(q, k, v, o, do, **kw), ref, BWD_TOL)


@pytest.mark.parametrize("b,s,t,h,kv,d,kw", FLASH_CASES[::3])
def test_flash_attention_records_its_backward(b, s, t, h, kv, d, kw):
    """The wrapper's Function on the CPU: the plain forward, its saved q, k,
    v and o, and the plain backward with the GQA sum."""
    q, k, v, do = _qkv(s + t + h, b, s, t, h, kv, d)
    o, ref = _autograd(q, k, v, do, kw)
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    out = flash_attention(qg, kg, vg, **kw)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    assert torch.equal(out.detach(), o)
    _close(torch.autograd.grad(out, (qg, kg, vg), do), ref, BWD_TOL)
    # without a tensor that requires grad, nothing is recorded
    assert flash_attention(q, k, v, **kw).grad_fn is None


def _scan(seed, b, s, r, device="cpu"):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor((0.1 * rng.standard_normal((b, s, r))).astype(np.float32), device=device)
    a = torch.as_tensor((0.85 + 0.149 * rng.random((b, s, r))).astype(np.float32), device=device)
    h0 = torch.as_tensor((0.1 * rng.standard_normal((b, r))).astype(np.float32), device=device)
    dh = torch.as_tensor(rng.standard_normal((b, s, r)).astype(np.float32), device=device)
    return x, a, h0, dh


@pytest.mark.parametrize("b,s,r,with_h0", [(2, 30, 8, True), (3, 17, 5, False), (1, 1, 4, True),
                                           (2, 40, 33, False)])
def test_scan_plain_backward_is_autograd_bit_for_bit(b, s, r, with_h0):
    x, a, h0, dh = _scan(s * r, b, s, r)
    h0 = h0 if with_h0 else None
    leaves = [t.clone().requires_grad_(True) for t in (x, a) + ((h0,) if with_h0 else ())]
    out = rg_lru_ref(*leaves[:2], leaves[2] if with_h0 else None)
    ref = torch.autograd.grad(out, leaves, dh)
    got = rg_lru_bwd_ref(a, out.detach(), h0, dh)
    for g, want in zip(got, ref):
        assert torch.equal(g, want)             # equal values: -0.0 == 0.0
    if not with_h0:
        # the only bits that differ: zeros of da at t = 0 (g_0 * h0 with h0 = 0)
        diff = got[1].view(torch.int32) != ref[1].view(torch.int32)
        assert not diff[:, 1:].any() and bool((got[1][diff] == 0).all())
    # the wrapper's Function takes the same plain backward
    leaves2 = [t.detach().clone().requires_grad_(True) for t in leaves]
    out2 = rg_lru_scan(*leaves2[:2], leaves2[2] if with_h0 else None)
    assert type(out2.grad_fn).__name__ == "_RGLRUScanBackward"
    for g, want in zip(torch.autograd.grad(out2, leaves2, dh), got):
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))


def test_bf16_backwards_raise_naming_the_roadmap():
    q, k, v, do = (t.bfloat16() for t in _qkv(0, 1, 8, 8, 2, 1, 64))
    out = flash_attention(q.requires_grad_(True), k, v)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.float().sum().backward()
    x, a, _, _ = (t.bfloat16() for t in _scan(0, 1, 5, 4))
    h = rg_lru_scan(x.requires_grad_(True), a)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        h.float().sum().backward()


# ---------------------------------------------------------------------------
# on the card: the backward kernels against the plain backwards
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc and run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,t,h,kv,d,kw", [
    *FLASH_CASES,
    # the training shapes: recurrentgemma-9b (16/1, 256, window 2048) at
    # s 64, and where the window bites; whisper-small's cross heads
    (8, 64, 64, 16, 1, 256, {"window": 2048}),
    (1, 2200, 2200, 16, 1, 256, {"window": 2048}),
    (2, 64, 16, 12, 12, 64, {"causal": False}),
    (1, 300, 300, 8, 4, 256, {"softcap": 50.0}),
])
def test_cuda_flash_backward_matches_plain(card, b, s, t, h, kv, d, kw):
    q, k, v, do = _qkv(s + t + h, b, s, t, h, kv, d, device=card)
    o = fa_mod.flash_attention_cuda(q, k, v, **kw)
    before = fa_mod.BWD_LAUNCHES[fa_mod.BWD]
    got = fa_mod.flash_attention_bwd_cuda(q, k, v, o, do, **kw)
    ref = flash_attention_bwd_ref(q, k, v, o, do, **kw)
    torch.cuda.synchronize()
    assert fa_mod.BWD_LAUNCHES[fa_mod.BWD] == before + 1
    _close(got, ref, CUDA_BWD_TOL)
    # no atomics: a second run gives the same bits
    for x, y in zip(got, fa_mod.flash_attention_bwd_cuda(q, k, v, o, do, **kw)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,r", [(8, 64, 4096), (2, 37, 100), (3, 70, 33), (1, 1, 64)])
def test_cuda_scan_backward_is_plain_bit_for_bit(card, b, s, r):
    x, a, h0, dh = _scan(s + r, b, s, r, device=card)
    h = rg_lru_ref(x, a, h0)
    before = rg_mod.BWD_LAUNCHES[rg_mod.BWD]
    got = rg_mod.rg_lru_scan_bwd_cuda(a, h, h0, dh)
    ref = rg_lru_bwd_ref(a, h, h0, dh)
    torch.cuda.synchronize()
    assert rg_mod.BWD_LAUNCHES[rg_mod.BWD] == before + 1
    for g, want in zip(got, ref):
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_cuda_outputs_carry_their_backward(card):
    """A loss built on the card's kernels sends gradient into q, k, v, x
    and a through the backward kernels."""
    q, k, v, do = (t.requires_grad_(True) for t in _qkv(1, 2, 64, 64, 4, 2, 64, device=card))
    x, a, _, dh = (t.requires_grad_(True) for t in _scan(2, 2, 64, 128, device=card))
    counts = {m: {**m.LAUNCHES, **m.BWD_LAUNCHES} for m in (fa_mod, rg_mod)}
    o = flash_attention(q, k, v)
    h = rg_lru_scan(x, a)
    assert o.grad_fn is not None and h.grad_fn is not None
    ((o * do).sum() + (h * dh).sum()).backward()
    for t in (q, k, v, x, a):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)
    assert fa_mod.LAUNCHES["flash_attention"] == counts[fa_mod]["flash_attention"] + 1
    assert fa_mod.BWD_LAUNCHES[fa_mod.BWD] == counts[fa_mod][fa_mod.BWD] + 1
    assert rg_mod.LAUNCHES["rg_lru_scan"] == counts[rg_mod]["rg_lru_scan"] + 1
    assert rg_mod.BWD_LAUNCHES[rg_mod.BWD] == counts[rg_mod][rg_mod.BWD] + 1
