"""The port's flash-attention and RG-LRU scan against the JAX package.

On the CPU the port's wrappers run their plain PyTorch versions; they are
held against the JAX Pallas kernels in interpret mode (``repro.kernels.ops``,
as tests/test_kernels.py runs them) and against ``repro.kernels.ref``, on the
f32 cases of tests/test_kernels.py.  MQA/GQA cases (K/V at their own head
count) are held against the JAX model's ``_sdpa``; ragged sequence lengths,
which the TPU wrapper does not take, against ``flash_attention_ref``.
Tolerances: 3e-5 for attention and 2e-4 for the scan (tests/test_kernels.py's
f32 bars).  Tests marked ``cuda`` hold the CUDA kernels against the plain
versions on the card and skip elsewhere.
"""
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
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain, repeat_kv
from repro_torch.kernels.ref import flash_attention_ref, rg_lru_ref
from repro_torch.kernels.rg_lru_scan import rg_lru_scan

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
    assert fa_mod.LAUNCHES == {"flash_attention": 0}
    assert rg_mod.LAUNCHES == {"rg_lru_scan": 0}


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


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d,kw", [
    *[(b, s, h, h, d, kw) for b, s, h, d, kw in FLASH_CASES],
    (2, 100, 4, 1, 64, {}),
    (1, 200, 4, 2, 128, {"window": 50}),
    (2, 300, 16, 1, 256, {"window": 128}),
])
def test_cuda_flash_kernel_matches_plain(card, b, s, h, kv, d, kw):
    q, k, v = (_t(a).to(card) for a in _qkv(s + h, b, s, h, kv, d))
    before = fa_mod.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_mod.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(out, ref, atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,r", [(8, 512, 256), (2, 37, 100), (2, 3072, 4096)])
def test_cuda_scan_kernel_matches_plain(card, b, s, r):
    x, a, h0 = (_t(t).to(card) for t in _scan_inputs(s, b, s, r))
    before = rg_mod.LAUNCHES["rg_lru_scan"]
    out = rg_lru_scan(x, a, h0)
    ref = rg_lru_ref(x, a, h0)
    torch.cuda.synchronize()
    assert rg_mod.LAUNCHES["rg_lru_scan"] == before + 1
    torch.testing.assert_close(out, ref, atol=SCAN_TOL, rtol=SCAN_TOL)
