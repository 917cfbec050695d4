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
CPU; the bf16 modes' backwards raise ``NotImplementedError``.  The flash
backward kernel's schedule is checked through its Python statement (its
constants against the CUDA source; every live (query head, query tile) pair
of every dK/dV key block walked once across the splits, in the unsplit
order), and a numpy emulation of its five products records why they run in
3xTF32 and not one TF32 pass.  Tests marked
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
from torch_tf32 import mm_tf32, tf32_rna


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread beats a pool of them,
    which only contends with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BWD_TOL = 1e-5
# the kernel against the plain backward on the card: 3xTF32 tensor-core
# products against float32 einsums in another order, and P recomputed from
# the row's log-sum-exp instead of softmax's max and sum
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
# the flash backward kernel's schedule and arithmetic, in Python
# ---------------------------------------------------------------------------

def test_bwd_schedule_constants_are_the_kernels():
    """The Python statement's constants are those the CUDA source builds with."""
    import re

    from repro_torch.kernels import build

    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    tune = {int(d): tuple(int(x) for x in rest) for d, *rest in re.findall(
        r"struct Tune<(\d+)> \{ static constexpr int Q_SPLIT = (\d+), Q_TILE = (\d+), "
        r"KV_SPLIT = (\d+), KV_TILE = (\d+); \};", src)}
    assert tune == fa_mod.BWD_TUNE and set(tune) == set(fa_mod.HEAD_DIMS)

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (fa_mod.BWD_WARPS, fa_mod.BWD_ROW_PAD, fa_mod.BWD_MAX_SPLIT) == (
        const("WARPS"), const("ROW_PAD"), const("MAX_SPLIT"))


# (s, t, h, kv, d, kw): causal, windows, the cross mode, GQA groups that the
# splits cut mid-head, one query, the training shapes
SPLIT_SHAPES = [
    (64, 64, 16, 1, 256, {"window": 2048}),
    (333, 333, 6, 2, 128, {"window": 70}),
    (100, 100, 6, 2, 128, {}),
    (77, 77, 6, 2, 256, {"window": 20}),
    (150, 150, 4, 2, 64, {"window": 33}),
    (64, 64, 12, 12, 64, {}),
    (40, 150, 8, 2, 256, {"causal": False}),
    (45, 1500, 12, 12, 64, {"causal": False}),
    (29, 29, 2, 2, 64, {"causal": False, "window": 5}),
    (1, 1, 4, 1, 64, {}),
]


@pytest.mark.parametrize("s,t,h,kv,d,kw", SPLIT_SHAPES)
@pytest.mark.parametrize("b", [1, 2, 8])
def test_bwd_splits_walk_every_live_pair_once_in_order(b, s, t, h, kv, d, kw):
    causal, window = kw.get("causal", True), kw.get("window")
    _, _, keys, tile = fa_mod.bwd_blocks(d)
    rep = h // kv

    def kept(i, j):
        return i < s and j < t and (not causal or j <= i) and (window is None or j > i - window)

    for sms in (132, 16, 1000):
        n = fa_mod.bwd_n_split(b, s, t, h, kv, d, sms)
        base = -(-t // keys) * kv * b
        assert 1 <= n <= fa_mod.BWD_MAX_SPLIT
        if base >= sms:
            assert n == 1
        else:
            # the fewest waves per split among the counts it may take
            cost = lambda m: -(-base * m // sms) / m
            cands = range(1, min(fa_mod.BWD_MAX_SPLIT, rep * -(-s // tile)) + 1)
            assert cost(n) == min(cost(m) for m in cands)
            assert all(cost(m) > cost(n) for m in cands if m < n)
        for j0 in range(0, t, keys):
            whole = fa_mod.bwd_dkv_walk(0, 1, j0, s, h, kv, d, causal, window, t)
            live = [qt for qt in range(-(-s // tile))
                    if any(kept(i, j) for i in range(qt * tile, (qt + 1) * tile)
                           for j in range(j0, min(j0 + keys, t)))]
            assert whole == [(hh, qt) for hh in range(rep) for qt in live]
            parts = [fa_mod.bwd_dkv_walk(sp, n, j0, s, h, kv, d, causal, window, t)
                     for sp in range(n)]
            assert [x for part in parts for x in part] == whole


def test_bwd_splits_fill_the_card_at_the_training_shapes():
    """recurrentgemma-9b's training shape (b 8, s 64, 16/1, d 256) has 16
    dK/dV blocks of 32 keys: 8 splits make 128 blocks on 132 SMs.  The long
    shapes and whisper-small's fill the card unsplit."""
    assert fa_mod.bwd_n_split(8, 64, 64, 16, 1, 256, 132) == 8
    for shape in [(2, 3072, 3072, 16, 1, 256), (1, 3072, 3072, 64, 8, 128),
                  (2, 3072, 3072, 8, 4, 256), (2, 448, 1500, 12, 12, 64),
                  (8, 64, 1500, 12, 12, 64)]:
        assert fa_mod.bwd_n_split(*shape, 132) == 1


def _bwd_products(q, k, v, o, do, mm, dt):
    """The five products of one causal head's backward (S, dP, dQ, dK, dV)
    through ``mm``, the elementwise steps in ``dt``."""
    sc = dt(1 / np.sqrt(q.shape[1]))
    s = np.where(np.tril(np.ones((q.shape[0], k.shape[0]), bool)), mm(q, k.T) * sc, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = (p / p.sum(-1, keepdims=True)).astype(dt)
    ds = (p * (mm(do, v.T) - (do * o).sum(-1, keepdims=True)) * sc).astype(dt)
    return mm(ds, k), mm(ds.T, q), mm(p.T, do)


def _mm_kernel(a, b):
    """a @ b as the backward kernel takes it: hi = tf32(x) rounded, lo = x -
    hi left whole and read by the tensor core as its top 19 bits;
    hi*lo + lo*hi + hi*hi summed in float32."""
    def cut(x):
        return (np.ascontiguousarray(x, np.float32).view(np.uint32)
                & np.uint32(0xFFFFE000)).view(np.float32)

    ah, bh = tf32_rna(a), tf32_rna(b)
    return (ah @ cut(b - bh) + cut(a - ah) @ bh) + ah @ bh


def test_three_tf32_passes_keep_the_backward_bar_and_one_does_not():
    s, d = 256, 256
    rng = np.random.default_rng(29)
    q, k, v, do = (rng.normal(size=(s, d)).astype(np.float32) for _ in range(4))
    x64 = [x.astype(np.float64) for x in (q, k, v, do)]
    sc = np.where(np.tril(np.ones((s, s), bool)), x64[0] @ x64[1].T / np.sqrt(d), -np.inf)
    p64 = np.exp(sc - sc.max(-1, keepdims=True))
    o64 = (p64 / p64.sum(-1, keepdims=True)) @ x64[2]
    ref = _bwd_products(*x64[:3], o64, x64[3], np.matmul, np.float64)
    top = max(np.abs(r).max() for r in ref)

    def err(mm):
        got = _bwd_products(q, k, v, o64.astype(np.float32), do, mm, np.float32)
        return max(np.abs(g - r).max() for g, r in zip(got, ref)) / top

    err32 = err(np.matmul)
    for err3 in (err(lambda a, b: mm_tf32(a, b, 3)), err(_mm_kernel)):
        assert err3 <= CUDA_BWD_TOL and err3 <= 4 * err32
    assert err(lambda a, b: mm_tf32(a, b, 1)) > CUDA_BWD_TOL


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
    # dK/dV walks cut into n_split > 1 ranges that cut GQA groups mid-head,
    # over ragged key blocks (12 splits at d 128, 9 at d 256 on 132 SMs)
    (2, 100, 100, 6, 2, 128, {}),
    (1, 77, 77, 6, 2, 256, {"window": 20}),
    # every head dim under a window; the cross mode with ragged key tiles
    (1, 150, 150, 4, 2, 64, {"window": 33}),
    (1, 150, 150, 4, 1, 128, {"window": 40}),
    (1, 45, 1500, 12, 12, 64, {"causal": False}),
    (2, 40, 150, 8, 2, 256, {"causal": False}),
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
def test_cuda_bwd_n_split_is_the_mirrors(card):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for s, t, h, kv, d, _ in SPLIT_SHAPES:
        for b in (1, 2, 8):
            for n in (sms, 16, 1000):
                assert fa_mod.bwd_n_split_cuda(b, s, t, h, kv, d, n) == fa_mod.bwd_n_split(
                    b, s, t, h, kv, d, n)


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
