"""The port's flash-attention and RG-LRU scan against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the JAX Pallas kernels in interpret mode (``repro.kernels.ops``,
as tests/test_kernels.py runs them) and against ``repro.kernels.ref``, on the
f32 cases of tests/test_kernels.py.  MQA/GQA cases (K/V at their own head
count) are held against the JAX model's ``_sdpa``; ragged sequence lengths,
which the TPU wrapper does not take, against ``flash_attention_ref``; the
cross mode (``t`` keys for ``s != t`` queries, no mask) against ``_sdpa``
under the model's non-causal mask.
Tolerances: 3e-5 for attention and 2e-4 for the scan (tests/test_kernels.py's
f32 bars).  Tests marked ``cuda`` hold the CUDA kernels against the plain
versions on the card and skip elsewhere.  The kernels' schedules (head
pairing, block order, live K/V tiles, the scan's prefetch ring) are checked
here through their Python statements; the bf16 scan's schedule is modelled
here (``bf16_schedule``) and walked by an emulation of its dataflow that
must equal the plain loop bit for bit.  A numpy emulation of tf32 rounding records why the flash kernel
runs 3xTF32 and not one TF32 pass.
"""
from typing import List, Tuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels.ref import flash_attention_ref as j_flash_ref
from repro.kernels.ref import rg_lru_ref as j_rg_lru_ref
from repro.models.attention import AttnSpec as JAttnSpec
from repro.models.attention import _mask_bias as j_mask_bias
from repro.models.attention import _sdpa as j_sdpa
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import rg_lru_scan as rg_mod
from repro_torch.kernels.flash_attention import (
    BLOCK_K,
    ROWS,
    block_order,
    flash_attention,
    flash_attention_plain,
    heads_per_block,
    kv_tile_range,
    repeat_kv,
)
from repro_torch.kernels.ref import flash_attention_ref, rg_lru_ref
from repro_torch.kernels.rg_lru_scan import (
    BF16_CHANNELS,
    BF16_LOAD_STAGES,
    BF16_OUT_STAGES,
    BF16_STAGE_STEPS,
    rg_lru_scan,
    rg_lru_scan_plain,
    ring_schedule,
)
from repro_torch.kernels.rg_lru_scan import F32_RING_STAGES as RING_STAGES
from repro_torch.kernels.rg_lru_scan import F32_STAGE_STEPS as STAGE_STEPS
from torch_tf32 import mm_tf32 as _mm
from torch_tf32 import tf32_rna as _tf32_rna

FLASH_TOL = 3e-5
SCAN_TOL = 2e-4


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _qkv(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    return q, k, v


FLASH_CASES = [
    (2, 256, 4, 64, {}),
    (1, 256, 2, 128, {"window": 64}),
    (2, 128, 2, 64, {"softcap": 50.0}),
    (1, 256, 2, 64, {"causal": False}),
    (1, 512, 1, 64, {"window": 100, "softcap": 30.0}),
]


@pytest.mark.parametrize("b,s,h,d,kw", FLASH_CASES)
def test_flash_plain_matches_jax_kernel_and_ref(b, s, h, d, kw):
    q, k, v = _qkv(b * s + h + d, b, s, h, h, d)
    out = flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    j_kernel = np.asarray(ops.flash_attention(jq, jk, jv, block_q=64, block_kv=64, **kw))
    j_ref = np.asarray(j_flash_ref(jq, jk, jv, **kw))
    np.testing.assert_allclose(out, j_kernel, atol=FLASH_TOL, rtol=FLASH_TOL)
    np.testing.assert_allclose(out, j_ref, atol=FLASH_TOL, rtol=FLASH_TOL)
    t_ref = flash_attention_ref(_t(q), _t(k), _t(v), **kw).numpy()
    np.testing.assert_allclose(t_ref, j_ref, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.parametrize("h,kv,kw", [
    (4, 1, {}),
    (4, 2, {"window": 48}),
    (8, 2, {"softcap": 50.0}),
    (16, 1, {"window": 64, "softcap": 30.0}),
])
def test_flash_gqa_matches_jax_sdpa_on_unrepeated_kv(h, kv, kw):
    b, s, d = 2, 128, 64
    q, k, v = _qkv(h * 10 + kv, b, s, h, kv, d)
    out = flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    spec = JAttnSpec(d_model=h * d, num_heads=h, num_kv_heads=kv, head_dim=d,
                     logit_softcap=kw.get("softcap"), window=kw.get("window"))
    pos = jnp.arange(s)
    bias = j_mask_bias(spec, pos, pos, jnp.float32)
    j_out = np.asarray(j_sdpa(spec, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias))
    np.testing.assert_allclose(out, j_out, atol=FLASH_TOL, rtol=FLASH_TOL)


def test_repeat_kv_is_head_major():
    x = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    r = repeat_kv(x, 3)
    assert r.shape == (2, 3, 6, 4)
    for hh in range(6):
        torch.testing.assert_close(r[:, :, hh], x[:, :, hh // 3])


@pytest.mark.parametrize("s,h,kv,kw", [
    (100, 4, 1, {}),
    (200, 4, 2, {"window": 50}),
    (37, 2, 2, {"softcap": 20.0, "window": 8}),
    (1, 2, 1, {}),
])
def test_flash_ragged_seq_matches_ref(s, h, kv, kw):
    b, d = 2, 64
    q, k, v = _qkv(s, b, s, h, kv, d)
    out = flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    rep = h // kv
    kr = np.repeat(k, rep, axis=2)
    vr = np.repeat(v, rep, axis=2)
    j_ref = np.asarray(j_flash_ref(jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr), **kw))
    assert out.shape == (b, s, h, d)
    np.testing.assert_allclose(out, j_ref, atol=FLASH_TOL, rtol=FLASH_TOL)


# (s, t, h, kv, kw) of the cross mode: Whisper's MHA at t above and below s
# and off the 32- and 64-key tiles, one query (decode), GQA, a softcap
CROSS_CASES = [
    (12, 16, 4, 4, {}), (129, 150, 4, 4, {}), (1, 45, 4, 1, {}), (70, 33, 8, 2, {}),
    (40, 97, 4, 2, {"softcap": 30.0}),
]


@pytest.mark.parametrize("s,t,h,kv,kw", CROSS_CASES)
def test_flash_cross_mode_matches_jax_sdpa(s, t, h, kv, kw):
    b, d = 2, 64
    rng = np.random.default_rng(s * 1000 + t)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, t, kv, d)).astype(np.float32) for _ in range(2))
    out = flash_attention(_t(q), _t(k), _t(v), causal=False, **kw).numpy()
    spec = JAttnSpec(d_model=h * d, num_heads=h, num_kv_heads=kv, head_dim=d, causal=False,
                     logit_softcap=kw.get("softcap"))
    bias = j_mask_bias(spec, jnp.arange(s), jnp.arange(t), jnp.float32)
    j_out = np.asarray(j_sdpa(spec, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias))
    assert out.shape == (b, s, h, d)
    np.testing.assert_allclose(out, j_out, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.parametrize("kw", [{}, {"causal": True}, {"window": 8}, {"causal": False, "window": 8}])
def test_flash_cross_mode_refuses_causal_and_window(kw):
    """``t != s`` takes no causal mask and no window: each is
    self-attention's (the default ``causal=True`` included)."""
    q, k = torch.zeros(1, 8, 2, 64), torch.zeros(1, 5, 1, 64)
    for call in (lambda: flash_attention(q, k, k, **kw), lambda: flash_attention_plain(q, k, k, **kw),
                 lambda: kv_tile_range(0, 64, 8, kw.get("causal", True), kw.get("window"), 32, t=5)):
        with pytest.raises(ValueError, match="causal"):
            call()
    # the same call at t == s, and the cross mode without either, run
    flash_attention_plain(q, q[:, :, :1], q[:, :, :1], **kw)
    assert flash_attention_plain(q, k, k, causal=False).shape == (1, 8, 2, 64)


def _scan_inputs(seed, b=8, s=512, r=256):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, s, r)) * 0.1).astype(np.float32)
    a = rng.uniform(0.85, 0.999, size=(b, s, r)).astype(np.float32)
    h0 = (rng.normal(size=(b, r)) * 0.1).astype(np.float32)
    return x, a, h0


@pytest.mark.parametrize("blocks", [(4, 128, 128), (8, 256, 128), (2, 64, 256)])
def test_rg_lru_plain_matches_jax_kernel_and_ref(blocks):
    bb, bs, bc = blocks
    x, a, h0 = _scan_inputs(bb * 1000 + bs + bc)
    out = rg_lru_scan(_t(x), _t(a), _t(h0)).numpy()
    jx, ja, jh = jnp.asarray(x), jnp.asarray(a), jnp.asarray(h0)
    j_kernel = np.asarray(ops.rg_lru_scan(jx, ja, jh, block_b=bb, block_s=bs, block_c=bc))
    j_ref = np.asarray(j_rg_lru_ref(jx, ja, jh))
    np.testing.assert_allclose(out, j_kernel, atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(out, j_ref, atol=SCAN_TOL, rtol=SCAN_TOL)


def test_rg_lru_h0_none_is_zeros():
    x, a, _ = _scan_inputs(7, b=2, s=128, r=128)
    out = rg_lru_scan(_t(x), _t(a)).numpy()
    j_kernel = np.asarray(ops.rg_lru_scan(jnp.asarray(x), jnp.asarray(a), block_b=2,
                                          block_s=64, block_c=128))
    np.testing.assert_allclose(out, j_kernel, atol=SCAN_TOL, rtol=SCAN_TOL)
    zeros = rg_lru_scan(_t(x), _t(a), torch.zeros(2, 128)).numpy()
    np.testing.assert_array_equal(out, zeros)
    np.testing.assert_allclose(rg_lru_ref(_t(x), _t(a)).numpy(),
                               np.asarray(j_rg_lru_ref(jnp.asarray(x), jnp.asarray(a))),
                               atol=SCAN_TOL, rtol=SCAN_TOL)


# ---------------------------------------------------------------------------
# routing: CPU -> plain version, other devices refused, launches counted
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    fa_mod.reset_launches()
    rg_mod.reset_launches()
    q, k, v = _qkv(0, 1, 64, 2, 1, 64)
    out = flash_attention(_t(q), _t(k), _t(v), window=16)
    torch.testing.assert_close(out, flash_attention_plain(_t(q), _t(k), _t(v), window=16),
                               rtol=0, atol=0)
    x, a, h0 = _scan_inputs(1, b=2, s=16, r=8)
    torch.testing.assert_close(rg_lru_scan(_t(x), _t(a), _t(h0)), rg_lru_ref(_t(x), _t(a), _t(h0)),
                               rtol=0, atol=0)
    assert fa_mod.LAUNCHES == {"flash_attention": 0, "flash_attention_bf16": 0}
    assert rg_mod.LAUNCHES == {"rg_lru_scan": 0, "rg_lru_scan_bf16": 0}


def test_other_devices_are_refused():
    q = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        flash_attention(q, q[:, :, :1], q[:, :, :1])
    x = torch.empty(1, 8, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rg_lru_scan(x, x)
    assert fa_mod.LAUNCHES["flash_attention"] == 0 and rg_mod.LAUNCHES["rg_lru_scan"] == 0


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc and run only on the card")
    return torch.device("cuda")


# (b, s, h, kv, d, kw) at the serve heads (recurrentgemma-9b: 16 query heads,
# MQA, head_dim 256, window 2048)
SERVE_HEADS = (16, 1, 256, {"window": 2048})


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d,kw", [
    *[(b, s, h, h, d, kw) for b, s, h, d, kw in FLASH_CASES],
    (2, 100, 4, 1, 64, {}),
    (1, 200, 4, 2, 128, {"window": 50}),
    (2, 300, 16, 1, 256, {"window": 128}),
    # heads that do not pair: h = 1, h = 3 with kv = 1, h / kv odd
    (1, 200, 1, 1, 64, {}),
    (2, 130, 3, 1, 128, {"window": 40}),
    (2, 150, 6, 2, 64, {}),
    (1, 97, 5, 5, 64, {"causal": False}),
    # lengths ragged under 128-row blocks and 32-key tiles
    *[(2, n, *SERVE_HEADS[:3], SERVE_HEADS[3]) for n in (1, 31, 129, 3072 + 17)],
    # windows narrower than one K/V tile
    (2, 300, 16, 1, 256, {"window": 7}),
    (1, 200, 3, 1, 64, {"window": 1}),
    (1, 100, 2, 1, 64, {"window": 5, "causal": False}),
    # head dims 64 and 128 at the serve length
    (2, 3072, 16, 1, 64, {"window": 2048}),
    (2, 3072, 16, 1, 128, {"window": 2048}),
    # the cross mode (t keys, kw["t"]): whisper-small's 12 heads against 1500
    # encoder frames (28 live keys in the last tile of either mode) at t
    # below s, above s and one query; internvl-like GQA 64/8 at head_dim 128
    (2, 3072, 12, 12, 64, {"t": 1500, "causal": False}),
    (2, 129, 12, 12, 64, {"t": 1500, "causal": False}),
    (2, 1, 12, 12, 64, {"t": 1500, "causal": False}),
    (1, 300, 64, 8, 128, {"t": 77, "causal": False}),
])
def test_cuda_flash_kernel_matches_plain(card, b, s, h, kv, d, kw):
    kw = dict(kw)
    t = kw.pop("t", s)
    q, k, v = (_t(a).to(card) for a in _qkv(s + h, b, max(s, t), h, kv, d))
    q, k, v = q[:, :s].contiguous(), k[:, :t].contiguous(), v[:, :t].contiguous()
    before = fa_mod.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_mod.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(out, ref, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,r", [
    (8, 512, 256), (2, 37, 100), (2, 3072, 4096),
    # R not a multiple of the 64-channel block, and not of 4 (4-byte loads)
    (2, 3072, 4100), (2, 777, 1001),
    # S shorter than the 128-step ring and not a multiple of a stage; S = 1
    (4, 100, 256), (2, 1, 64),
])
def test_cuda_scan_kernel_matches_plain(card, b, s, r):
    x, a, h0 = (_t(t).to(card) for t in _scan_inputs(s, b, s, r))
    before = rg_mod.LAUNCHES["rg_lru_scan"]
    out = rg_lru_scan(x, a, h0)
    ref = rg_lru_ref(x, a, h0)
    torch.cuda.synchronize()
    assert rg_mod.LAUNCHES["rg_lru_scan"] == before + 1
    torch.testing.assert_close(out, ref, atol=SCAN_TOL, rtol=SCAN_TOL)
    # the same rounded multiply and add per step as the plain loop
    assert torch.equal(out, ref)


# ---------------------------------------------------------------------------
# the kernels' schedules, stated in Python
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,kv,pairs", [
    (16, 1, True), (8, 2, True), (4, 4, False), (1, 1, False), (3, 1, False), (6, 2, False),
    (12, 3, True), (9, 3, False), (12, 6, True), (10, 2, False),
])
def test_heads_pair_only_within_one_kv_head(h, kv, pairs):
    hpb = heads_per_block(h, kv)
    assert hpb == (2 if pairs else 1)
    rep = h // kv
    for head0 in range(0, h, hpb):
        assert len({hh // rep for hh in range(head0, head0 + hpb)}) == 1


# each mode's K/V tile (csrc/flash_attention.cu: 32 keys in float32, 64 in bf16)
MODES = {"float32": BLOCK_K[torch.float32], "bfloat16": BLOCK_K[torch.bfloat16]}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("b,s,h,kv", [
    (2, 3072, 16, 1), (2, 3089, 16, 1), (1, 1, 16, 1), (2, 31, 16, 1), (1, 129, 3, 1),
    (2, 150, 6, 2), (1, 200, 1, 1), (3, 64, 2, 2),
])
def test_block_order_covers_every_row_once_longest_first(b, s, h, kv, mode):
    order = block_order(b, s, h, kv)
    hpb = heads_per_block(h, kv)
    positions = ROWS // hpb
    seen = np.zeros((b, h, s), np.int64)
    for p0, bb, head0, n in order:
        assert n == hpb and 0 <= p0 < s
        seen[bb, head0:head0 + n, p0:p0 + positions] += 1
    assert (seen == 1).all()
    # last query tiles first; with a causal mask and no window the K/V tiles
    # each block walks never grow along the launch order
    starts = [p0 for p0, _, _, _ in order]
    assert starts == sorted(starts, reverse=True)
    work = [np.subtract(*kv_tile_range(p0, positions, s, True, None, MODES[mode])[::-1])
            for p0 in starts]
    assert all(w1 >= w2 for w1, w2 in zip(work, work[1:]))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("s,positions,causal,window", [
    (3072, 64, True, 2048), (3089, 64, True, 2048), (300, 128, True, 7), (200, 128, True, 1),
    (100, 128, False, 5), (257, 64, False, None), (129, 128, True, None), (31, 64, True, 2048),
])
def test_kv_tile_range_holds_exactly_the_live_tiles(s, positions, causal, window, mode):
    bk = MODES[mode]

    def kept(i, j):
        return j < s and (not causal or j <= i) and (window is None or j > i - window)

    for p0 in range(0, s, positions):
        rows = range(p0, min(p0 + positions, s))
        begin, end = kv_tile_range(p0, positions, s, causal, window, bk)
        live = [kt for kt in range(-(-s // bk))
                if any(kept(i, j) for i in rows for j in range(kt * bk, (kt + 1) * bk))]
        # every live tile is walked; the walk starts and ends on live tiles
        assert begin <= live[0] and live[-1] < end
        assert begin in live and end - 1 in live


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("s,t", [(3072, 1500), (129, 1500), (1, 1500), (12, 16), (24, 16), (300, 77)])
def test_kv_tile_range_cross_mode_walks_every_key_tile(s, t, mode):
    """Cross mode: every block of query positions walks all of the ``t``
    keys' tiles, the last one ragged (1500 frames leave 28 keys in it at 32
    and at 64 keys a tile)."""
    bk = MODES[mode]
    for positions in (64, 128):
        for p0 in range(0, s, positions):
            assert kv_tile_range(p0, positions, s, False, None, bk, t=t) == (0, -(-t // bk))
    if t == 1500:
        assert t - (-(-t // bk) - 1) * bk == 28


@pytest.mark.parametrize("s", [1, 31, 32, 100, 127, 128, 129, 255, 1000, 3072])
def test_scan_ring_issues_each_stage_once_ahead_of_its_walk(s):
    n = -(-s // STAGE_STEPS)
    slots = {}                         # ring slot -> stage in it
    issued, walked = [], []
    for ev, st in ring_schedule(s):
        slot = st % RING_STAGES
        if ev == "issue":
            # the slot is empty or holds a stage already walked
            assert slots.get(slot) is None or slots[slot] in walked
            slots[slot] = st
            issued.append(st)
            assert len(issued) - len(walked) <= RING_STAGES
        else:
            assert slots[slot] == st and st in issued
            walked.append(st)
    assert issued == list(range(n)) and walked == list(range(n))
    # the stages cover the s steps once: full stages, then a short last one
    assert (n - 1) * STAGE_STEPS < s <= n * STAGE_STEPS


def bf16_schedule(s: int, r: int) -> List[Tuple[str, int, int, int, range, range]]:
    """A model of the bf16 kernel (``csrc/rg_lru_scan.cu``, namespace
    ``bf16``): every block's order of events over ``s`` steps and ``r``
    channels, as one order its barriers allow: the producer warp runs
    ahead as far as its ring's free slots let it.  Each event is ``(kind,
    block, stage, slot, steps, channels)``, ``steps`` and ``channels`` the
    part of the tile inside ``[0, s) x [0, r)``:

    - ``load``: the producer lands stage ``st``'s tile of ``a`` and ``x`` in
      ring slot ``st % BF16_LOAD_STAGES`` (zeros past ``s`` and ``r``), once
      the walk of stage ``st - BF16_LOAD_STAGES`` has freed it;
    - ``walk``: the walkers walk the ring slot in step order;
    - ``stage``: they write its ``h_t`` in output slot ``st %
      BF16_OUT_STAGES``;
    - ``free``: they free the ring slot;
    - ``left``: the store of an earlier stage has read its output slot
      (waited for before the walkers pass the barrier after stage ``st``,
      for the store that last read the slot stage ``st + 1`` writes);
    - ``store``: one walker sends the output slot to device memory as whole
      rows.
    """
    T, L, O, CH = BF16_STAGE_STEPS, BF16_LOAD_STAGES, BF16_OUT_STAGES, BF16_CHANNELS
    n = -(-s // T)
    events: List[Tuple[str, int, int, int, range, range]] = []
    for blk in range(-(-r // CH)):
        chans = range(blk * CH, min(blk * CH + CH, r))
        order: List[Tuple[str, int, int]] = []
        loaded, pending = 0, []
        for st in range(n):
            while loaded < n and loaded < st + L:    # slot of stage loaded - L freed
                order.append(("load", loaded, loaded % L))
                loaded += 1
            order += [("walk", st, st % L), ("stage", st, st % O), ("free", st, st % L)]
            while pending and pending[0] <= st + 1 - O:
                done = pending.pop(0)
                order.append(("left", done, done % O))
            order.append(("store", st, st % O))
            pending.append(st)
        order += [("left", done, done % O) for done in pending]
        events += [(kind, blk, st, slot, range(st * T, min(st * T + T, s)), chans)
                   for kind, st, slot in order]
    return events



@pytest.mark.parametrize("r", [8, 40, 100, 1000, 4096])
@pytest.mark.parametrize("s", [1, 31, 32, 777, 3072])
def test_bf16_scan_schedule_moves_each_step_once_and_reuses_no_slot_early(s, r):
    loaded, walked, stored = (np.zeros((s, r), np.uint8) for _ in range(3))
    ring, outs, last_walk = {}, {}, {}    # (block, slot) -> stage held, None when free
    for kind, blk, st, slot, steps, chans in bf16_schedule(s, r):
        assert steps.start == st * BF16_STAGE_STEPS and chans.start == blk * BF16_CHANNELS
        cell = (slice(steps.start, steps.stop), slice(chans.start, chans.stop))
        if kind == "load":
            # a ring slot is loaded only once the walk of its last stage freed it
            assert slot == st % BF16_LOAD_STAGES and ring.get((blk, slot)) is None
            ring[blk, slot] = st
            loaded[cell] += 1
        elif kind == "walk":
            # stages walked in step order, each from the slot that holds it
            assert ring[blk, slot] == st and last_walk.get(blk, -1) == st - 1
            last_walk[blk] = st
            walked[cell] += 1
        elif kind == "stage":
            # an output slot is written only once the store that read it left
            assert slot == st % BF16_OUT_STAGES and outs.get((blk, slot)) is None
            outs[blk, slot] = ("staged", st)
        elif kind == "free":
            assert ring[blk, slot] == st
            ring[blk, slot] = None
        elif kind == "store":
            assert outs[blk, slot] == ("staged", st)
            outs[blk, slot] = ("storing", st)
            stored[cell] += 1
        else:
            assert kind == "left" and outs[blk, slot] == ("storing", st)
            outs[blk, slot] = None
    assert (loaded == 1).all() and (walked == 1).all() and (stored == 1).all()
    assert not any(v is not None for v in (*ring.values(), *outs.values()))
    assert last_walk == {blk: -(-s // BF16_STAGE_STEPS) - 1 for blk in range(-(-r // BF16_CHANNELS))}


def test_scan_schedule_constants_are_the_kernels():
    """The Python models' constants are those the CUDA source builds with."""
    import re

    from repro_torch.kernels import build

    src = (build.CSRC / "rg_lru_scan.cu").read_text()
    f32, bf16 = src.split("namespace bf16 {")

    def const(part, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", part).group(1))

    assert (rg_mod.F32_CHANNELS, STAGE_STEPS, RING_STAGES) == (
        32 * const(f32, "CPL"), const(f32, "T"), const(f32, "STAGES"))
    assert (rg_mod.BF16_WALKERS, BF16_STAGE_STEPS, BF16_LOAD_STAGES, BF16_OUT_STAGES) == (
        const(bf16, "WALKERS"), const(bf16, "T"), const(bf16, "LOAD_STAGES"),
        const(bf16, "OUT_STAGES"))
    assert BF16_CHANNELS == 32 * rg_mod.BF16_WALKERS


def _bf16_scan_emulated(x, a, h0):
    """The bf16 kernel's dataflow on the CPU, in ``bf16_schedule``'s order:
    tiles land in ring slots (zeros past s and r), the walk takes a slot's
    steps in order (a rounded multiply, then a rounded add, in float32) and
    stages each h_t as bf16, and a store copies the staged rows inside
    ``[0, s) x [0, r)`` out."""
    b, s, r = x.shape
    T, CH = BF16_STAGE_STEPS, BF16_CHANNELS
    out = torch.full((b, s, r), float("nan"), dtype=torch.bfloat16)
    ring, outs, carry = {}, {}, {}
    for kind, blk, _, slot, steps, chans in bf16_schedule(s, r):
        part = (slice(None), slice(steps.start, steps.stop), slice(chans.start, chans.stop))
        if kind == "load":
            ta, tx = (torch.zeros(b, T, CH, dtype=torch.bfloat16) for _ in range(2))
            ta[:, : len(steps), : len(chans)] = a[part]
            tx[:, : len(steps), : len(chans)] = x[part]
            ring[blk, slot] = (ta, tx)
        elif kind == "walk":
            if blk not in carry:
                carry[blk] = torch.zeros(b, CH)
                carry[blk][:, : len(chans)] = h0[:, chans.start : chans.stop]
            ta, tx = ring[blk, slot]
            h, rows = carry[blk], []
            for u in range(T):
                h = ta[:, u].float() * h
                h = h + tx[:, u].float()
                rows.append(h.to(torch.bfloat16))
            carry[blk], walked = h, torch.stack(rows, 1)
        elif kind == "stage":
            outs[blk, slot] = walked
        elif kind == "store":
            out[part] = outs[blk, slot][:, : len(steps), : len(chans)]
    return out


@pytest.mark.parametrize("b,s,r", [(2, 777, 1000), (1, 1, 40), (3, 37, 100), (2, 130, 8),
                                   (1, 64, 4096)])
def test_bf16_scan_schedule_emulation_is_bit_identical_to_plain(b, s, r):
    rng = np.random.default_rng(s * 7 + r)
    x = torch.from_numpy((rng.normal(size=(b, s, r)) * 0.1).astype(np.float32)).bfloat16()
    a = torch.from_numpy(rng.uniform(0.85, 0.999, size=(b, s, r)).astype(np.float32)).bfloat16()
    h0 = torch.from_numpy((rng.normal(size=(b, r)) * 0.1).astype(np.float32))
    out = _bf16_scan_emulated(x, a, h0)
    assert torch.equal(out, rg_lru_scan_plain(x, a, h0))


# ---------------------------------------------------------------------------
# why 3xTF32: a numpy emulation of the kernel's arithmetic against float64
# ---------------------------------------------------------------------------

def _tf32_rna_reference(x):
    """The same rounding from its definition, in float64."""
    x = np.asarray(x, np.float64)
    m, e = np.frexp(x)                       # x = m 2^e, 0.5 <= |m| < 1
    scaled = np.abs(m) * 2.0 ** 11           # 11 significant bits
    r = np.floor(scaled + 0.5)               # ties away from zero on |m|
    return (np.sign(m) * r * 2.0 ** (e - 11)).astype(np.float32)


def _attention(q, k, v, matmul):
    d = q.shape[-1]
    s = matmul(q, k.T) * np.float32(1 / np.sqrt(d))
    s = np.where(np.tril(np.ones(s.shape, bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return matmul(p / p.sum(-1, keepdims=True), v)


def test_tf32_rounding_matches_its_definition():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(-6, 6, size=4096),
                        [0.0, -0.0, 1.0, -1.5, 1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11]]).astype(np.float32)
    np.testing.assert_array_equal(_tf32_rna(x), _tf32_rna_reference(x))
    assert _tf32_rna(np.float32(1 + 2.0 ** -11)) == np.float32(1 + 2.0 ** -10)   # tie: away


def test_three_tf32_passes_keep_the_f32_bar_and_one_does_not():
    s, d = 256, 256
    rng = np.random.default_rng(14)
    q, k, v = (rng.normal(size=(s, d)).astype(np.float32) for _ in range(3))
    ref = _attention(q.astype(np.float64), k.astype(np.float64), v.astype(np.float64), np.matmul)
    top = np.abs(ref).max()
    err3 = np.abs(_attention(q, k, v, lambda a, b: _mm(a, b, 3)) - ref).max() / top
    err1 = np.abs(_attention(q, k, v, lambda a, b: _mm(a, b, 1)) - ref).max() / top
    err32 = np.abs(_attention(q, k, v, np.matmul) - ref).max() / top
    assert err3 <= FLASH_TOL and err3 <= 4 * err32
    assert err1 > FLASH_TOL


# ---------------------------------------------------------------------------
# the bf16 instance's P V: P split into three bf16 parts, emulated in numpy
# ---------------------------------------------------------------------------

def _bf16_rn(x):
    """Round float32 to bf16 (8 significant bits), nearest, ties to even:
    __float2bfloat16_rn on finite values, as float32."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def _bf16_parts(p):
    """The kernel's split3: b1 = bf16(p), b2 = bf16(p - b1),
    b3 = bf16(p - b1 - b2), the differences taken in float32."""
    b1 = _bf16_rn(p)
    r1 = (p - b1).astype(np.float32)
    b2 = _bf16_rn(r1)
    return b1, b2, _bf16_rn((r1 - b2).astype(np.float32))


def test_three_bf16_parts_sum_back_to_p_exactly():
    rng = np.random.default_rng(24)
    n = 1 << 16
    # every float32 exponent from 2^-100 to 2^0, random 23-bit significands,
    # and the edges: 1, 2^-100, the top of a binade, halfway cases
    p = np.ldexp(1.0 + rng.integers(0, 1 << 23, size=n) / 2.0 ** 23, -rng.integers(1, 101, size=n))
    edges = [1.0, 2.0 ** -100, 1 - 2.0 ** -24, 2.0 ** -100 * (2 - 2.0 ** -23), 1 + 2.0 ** -8,
             0.5 + 2.0 ** -10 + 2.0 ** -18, 0.75 - 2.0 ** -24]
    p = np.concatenate([p, edges]).astype(np.float32)
    p = p[(p >= 2.0 ** -100) & (p <= 1.0)]
    parts = _bf16_parts(p)
    for b in parts:     # each part is a bf16 value
        assert not (b.view(np.uint32) & 0xFFFF).any()
    total = sum(b.astype(np.float64) for b in parts)
    np.testing.assert_array_equal(total, p.astype(np.float64))


def test_three_bf16_parts_keep_the_f32_bar_and_one_does_not():
    s, d = 256, 256
    rng = np.random.default_rng(24)
    q, k, v = (_bf16_rn(rng.normal(size=(s, d)).astype(np.float32)) for _ in range(3))
    scores = (q.astype(np.float64) @ k.T.astype(np.float64) / np.sqrt(d)).astype(np.float32)
    scores = np.where(np.tril(np.ones((s, s), bool)), scores, -np.inf)
    e = np.exp(scores - scores.max(-1, keepdims=True))
    p = (e / e.sum(-1, keepdims=True)).astype(np.float32)          # float32 P, as the kernel keeps it
    ref = p.astype(np.float64) @ v.astype(np.float64)
    top = np.abs(ref).max()
    b1, b2, b3 = _bf16_parts(p)
    # bf16 x bf16 products are exact in float32; the sums are float32
    err3 = np.abs(((b3 @ v) + (b2 @ v)) + (b1 @ v) - ref).max() / top
    err1 = np.abs(b1 @ v - ref).max() / top
    err32 = np.abs(p @ v - ref).max() / top
    assert err3 <= FLASH_TOL and err3 <= 4 * max(err32, 2.0 ** -24)
    assert err1 > FLASH_TOL
