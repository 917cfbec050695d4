"""The bf16 modes of the port's three kernels and LLM serving at
``ModelConfig.dtype="bfloat16"``, against the JAX package on the CPU.

Every input is made from a seeded numpy draw and rounded to bf16 the same
way on both sides (round to nearest even), which the helpers check bit for
bit.  On the CPU each wrapper runs its plain version: the bf16 operands
upcast, the function computed in float32 and rounded to bf16 once, as the
Pallas kernels do in interpret mode (``repro.kernels.ops``).  Bars:

* the kernels: tests/test_kernels.py's bf16 bars, 2e-2 for pruned_matmul
  (its gradients too, against the JAX ``custom_vjp``) with pruned units
  exact zeros, 3e-2 for attention; the scan within one bf16 ulp of the
  Pallas kernel (its log-space block form rounds differently in float32,
  then both round to bf16);
* the models: E, the JAX package's own bf16 envelope measured in the same
  test (max|JAX bf16 logits - JAX float32 logits of the same weights,
  upcast exactly|); the port's bf16 logits lie within 2E of JAX bf16 and of
  JAX float32, its greedy tokens equal JAX bf16's wherever JAX's top-2
  margin exceeds 2E, and its decode lies within 2E of its own forward.

The ``cuda``-marked twins hold each bf16 kernel against its plain version
on the card and skip elsewhere.  The JAX package is imported by the ``J``
fixture, not by the module, so that the twins also run where JAX is
absent: ``python -m pytest -m cuda tests/test_torch_bf16.py`` on the card.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import pruned_matmul as pm_mod
from repro_torch.kernels import rg_lru_scan as rg_mod
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.pruned_matmul import pruned_matmul, pruned_matmul_plain
from repro_torch.kernels.rg_lru_scan import rg_lru_scan, rg_lru_scan_plain
from repro_torch.launch import serve as t_serve
from repro_torch.models import transformer as TT


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread beats a pool of them,
    which only contends with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PM_TOL = 2e-2
FLASH_TOL = 3e-2
ARCHS = ["recurrentgemma-9b", "gemma2-2b", "internlm2-1.8b", "qwen1.5-32b", "qwen3-32b",
         "granite-moe-1b-a400m", "llama4-maverick-400b-a17b", "xlstm-1.3b", "whisper-small",
         "internvl2-76b"]


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules used here."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import smoke_config
    from repro.kernels import ops
    from repro.models import transformer

    # the JAX init as one compiled program (its eager random ops compile one by one)
    init = jax.jit(transformer.init_params, static_argnums=1)
    return types.SimpleNamespace(jax=jax, jnp=jnp, ops=ops, T=transformer, smoke_config=smoke_config,
                                 init=init)


def _pair(J, a: np.ndarray):
    """A float32 array rounded to bf16 on both sides: (jax, torch), equal
    bit for bit."""
    j = J.jnp.asarray(a, J.jnp.float32).astype(J.jnp.bfloat16)
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(j).view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))
    return j, t


def _f32(a) -> np.ndarray:
    """A bf16 array or tensor as float32 numpy (exact)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the Pallas kernels in bf16
# ---------------------------------------------------------------------------

# tests/test_kernels.py's pruned_matmul cases
PM_CASES = [
    (128, 256, 128, 256, 128),
    (256, 512, 384, 300, 200),
    (128, 384, 256, 128, 64),
    (128, 256, 128, 1, 1),
]


def _pm_inputs(M, K, N, keep_k, keep_n):
    rng = np.random.default_rng(M + K + N + keep_k)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    im = np.zeros(K, np.float32)
    im[:keep_k] = 1
    om = np.zeros(N, np.float32)
    om[:keep_n] = 1
    return x, w, im, om


@pytest.mark.parametrize("M,K,N,keep_k,keep_n", PM_CASES)
def test_bf16_pruned_matmul_plain_matches_jax_kernel(J, M, K, N, keep_k, keep_n):
    x, w, im, om = _pm_inputs(M, K, N, keep_k, keep_n)
    (jx, tx), (jw, tw) = _pair(J, x), _pair(J, w)
    y = pruned_matmul(tx, tw, torch.from_numpy(im), torch.from_numpy(om))
    assert y.dtype == torch.bfloat16 and y.shape == (M, N)
    jy = J.ops.pruned_matmul(jx, jw, J.jnp.asarray(im), J.jnp.asarray(om))
    np.testing.assert_allclose(_f32(y), _f32(jy), atol=PM_TOL, rtol=PM_TOL)
    if keep_n < N:
        assert np.abs(_f32(y)[:, keep_n:]).max() == 0.0


@pytest.mark.parametrize("M,K,N,keep_k,keep_n", PM_CASES[1:3])
def test_bf16_pruned_matmul_gradients_match_jax_custom_vjp(J, M, K, N, keep_k, keep_n):
    """dX and dW in bf16: the cotangent cast to x's dtype and both products
    in the kernel's mode, as ``_pm_bwd`` runs them."""
    x, w, im, om = _pm_inputs(M, K, N, keep_k, keep_n)
    row = (np.random.default_rng(M).random(M) < 0.8).astype(np.float32)
    g = np.random.default_rng(K).normal(size=(M, N)).astype(np.float32)
    (jx, tx), (jw, tw), (jg, tg) = _pair(J, x), _pair(J, w), _pair(J, g)
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    y = pruned_matmul(tx, tw, torch.from_numpy(im), torch.from_numpy(om), torch.from_numpy(row))
    y.backward(tg)
    _, vjp = J.jax.vjp(lambda a, b: J.ops.pruned_matmul(a, b, J.jnp.asarray(im), J.jnp.asarray(om),
                                                    J.jnp.asarray(row)), jx, jw)
    jdx, jdw = vjp(jg)
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    assert jdx.dtype == jdw.dtype == J.jnp.bfloat16
    for t, j in ((tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_allclose(_f32(t), _f32(j), atol=PM_TOL, rtol=PM_TOL)
    # pruned units get exactly zero gradient
    assert np.abs(_f32(tx.grad)[:, keep_k:]).max() == 0.0
    assert np.abs(_f32(tw.grad)[keep_k:]).max() == 0.0 and np.abs(_f32(tw.grad)[:, keep_n:]).max() == 0.0
    assert np.abs(_f32(tx.grad)[row == 0]).max() == 0.0


# tests/test_kernels.py's flash cases
FLASH_CASES = [
    (2, 256, 4, 64, {}),
    (1, 256, 2, 128, {"window": 64}),
    (2, 128, 2, 64, {"softcap": 50.0}),
    (1, 256, 2, 64, {"causal": False}),
    (1, 512, 1, 64, {"window": 100, "softcap": 30.0}),
]


@pytest.mark.parametrize("b,s,h,d,kw", FLASH_CASES)
def test_bf16_flash_plain_matches_jax_kernel(J, b, s, h, d, kw):
    rng = np.random.default_rng(b * s + h + d)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(J, rng.normal(size=(b, s, h, d))) for _ in range(3))
    out = flash_attention(tq, tk, tv, **kw)
    assert out.dtype == torch.bfloat16
    j_out = J.ops.flash_attention(jq, jk, jv, block_q=64, block_kv=64, **kw)
    np.testing.assert_allclose(_f32(out), _f32(j_out), atol=FLASH_TOL, rtol=FLASH_TOL)


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def test_bf16_scan_plain_within_one_ulp_of_jax_kernel(J):
    """Both modes compute in float32 from the upcast inputs and round once,
    so the bf16 outputs differ by at most one bf16 ulp beyond the two
    algorithms' float32 difference (the Pallas log-space block form loses
    ~1e-6 absolute where the sum cancels near zero); that float32
    difference is measured here on the same inputs."""
    rng = np.random.default_rng(7)
    (jx, tx) = _pair(J, rng.normal(size=(8, 512, 256)) * 0.1)
    (ja, ta) = _pair(J, rng.uniform(0.85, 0.999, size=(8, 512, 256)))
    h = rg_lru_scan(tx, ta)
    assert h.dtype == torch.bfloat16
    jh = _f32(J.ops.rg_lru_scan(jx, ja))
    ph = _f32(h)
    # the plain loop is the float32 recurrence on the upcast inputs, rounded once
    ph32 = rg_lru_scan(tx.float(), ta.float())
    assert torch.equal(h, ph32.to(torch.bfloat16))
    jh32 = np.asarray(J.ops.rg_lru_scan(jx.astype(J.jnp.float32), ja.astype(J.jnp.float32)))
    np.testing.assert_array_equal(jh, _f32(J.jnp.asarray(jh32).astype(J.jnp.bfloat16)))
    f32_diff = np.abs(ph32.numpy() - jh32)
    assert f32_diff.max() < 1e-5
    one_ulp = _bf16_ulp(np.maximum(np.abs(ph), np.abs(jh)))
    assert np.all(np.abs(ph - jh) <= one_ulp + f32_diff)
    assert np.mean(ph == jh) > 0.99


@pytest.mark.parametrize("which", ["pruned_matmul", "flash_attention", "rg_lru_scan"])
def test_float16_and_mixed_dtypes_are_refused_by_name(which):
    h, f = torch.zeros(2, 8, 2, 64, dtype=torch.float16), torch.zeros(2, 8, 2, 64)
    calls = {
        "pruned_matmul": lambda a, b: pruned_matmul(a[0, :, 0], b[0, 0], torch.ones(64), torch.ones(64)),
        "flash_attention": lambda a, b: flash_attention(a, b, b),
        "rg_lru_scan": lambda a, b: rg_lru_scan(a[:, :, 0], b[:, :, 0]),
    }[which]
    with pytest.raises(ValueError, match=rf"{which}: .*float16"):
        calls(h, h)
    with pytest.raises(ValueError, match=rf"{which}: .*dtype"):
        calls(f, f.to(torch.bfloat16))
    with pytest.raises(ValueError, match=rf"{which}: .*dtype"):
        calls(f.to(torch.bfloat16), f)


# ---------------------------------------------------------------------------
# dtype trees, conversion
# ---------------------------------------------------------------------------

def _dtypes(tree):
    """Shapes and dtype names of a tree of tensors or numpy arrays."""
    if isinstance(tree, dict):
        return {k: _dtypes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_dtypes(v) for v in tree]
    name = str(tree.dtype).replace("torch.", "") if isinstance(tree, torch.Tensor) else tree.dtype.name
    return tuple(tree.shape), name


def test_bf16_layers_match_jax(J):
    """rms_norm, layer_norm and apply_rope compute in float32 and round back
    to the input's bf16 once, as the JAX layers do: within one bf16 ulp of
    them (their float32 rsqrt and sin/cos may differ in the last bits)."""
    from repro.models import layers as jl
    from repro_torch.models import layers as tl

    rng = np.random.default_rng(3)
    (jx, tx), (js, ts), (jb, tb) = (_pair(J, rng.normal(size=n) * m) for n, m in
                                    (((2, 7, 3, 64), 3.0), ((64,), 0.1), ((64,), 0.1)))
    pos = np.arange(7) + 3000
    sin, cos = tl.rotary_embedding(torch.as_tensor(pos), 64)
    jsin, jcos = jl.rotary_embedding(J.jnp.asarray(pos), 64)
    pairs = [
        (tl.rms_norm(tx, ts), jl.rms_norm(jx, js)),
        (tl.layer_norm(tx, ts + 1, tb), jl.layer_norm(jx, js + 1, jb)),
        (tl.apply_rope(tx, sin, cos), jl.apply_rope(jx, jsin, jcos)),
    ]
    for t, j in pairs:
        assert t.dtype == torch.bfloat16 and j.dtype == J.jnp.bfloat16
        np.testing.assert_allclose(_f32(t), _f32(j), rtol=2.0 ** -7, atol=1e-6)
        assert np.mean(_f32(t) == _f32(j)) > 0.95
    g = torch.Generator().manual_seed(0)
    assert tl.dense_init(g, 8, 4, lead=(3,), dtype=torch.bfloat16).dtype == torch.bfloat16
    assert tl.normal_init(g, (3, 4), 0.02, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_init_and_decode_state_trees_match_jax(J, arch):
    tc = t_configs.smoke_config(arch).replace(dtype="bfloat16")
    jc = J.smoke_config(arch).replace(dtype="bfloat16")
    tp = TT.init_params(torch.Generator().manual_seed(0), tc)
    jp = J.jax.eval_shape(lambda k: J.T.init_params(k, jc), J.jax.random.PRNGKey(0))
    assert _dtypes(tp) == _dtypes(jp)
    assert tp["embed"].dtype == torch.bfloat16
    ts = TT.init_decode_state(tc, 2, 40)
    js = J.jax.eval_shape(lambda: J.T.init_decode_state(jc, 2, 40))
    assert _dtypes(ts["caches"]) == _dtypes(js["caches"])
    if "rglru" in tc.block_pattern:
        # as in the JAX package: the recurrence's parameter and state in float32
        assert tp["blocks"]["s0"]["rglru"]["lam"].dtype == torch.float32
        assert ts["caches"]["blocks"]["s0"]["h"].dtype == torch.float32
    if tc.num_experts:
        # the MoE router stays float32, the experts take the model dtype
        moe = tp["blocks"][f"s{tc.block_pattern.index('moe')}"]["moe"]
        assert moe["w_router"].dtype == torch.float32 and moe["w_gate"].dtype == torch.bfloat16
    if "mlstm" in tc.block_pattern:
        # the xLSTM gates and recurrent states stay float32
        assert tp["blocks"]["s0"]["cell"]["w_i"].dtype == torch.float32
        assert ts["caches"]["blocks"]["s0"]["C"].dtype == torch.float32


def test_bf16_leaves_round_trip_through_convert_bit_for_bit(J):
    jc = J.smoke_config("recurrentgemma-9b").replace(dtype="bfloat16")
    jp = J.jax.tree.map(np.asarray, J.init(J.jax.random.PRNGKey(1), jc))
    tp = tree_from_numpy(jp)
    leaves_j, leaves_t = J.jax.tree.leaves(jp), J.jax.tree.leaves(tp)
    assert len(leaves_j) == len(leaves_t)
    for j, t in zip(leaves_j, leaves_t):
        if j.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), j.view(np.uint16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), j)
    back = tree_to_numpy(tp)
    for j, b, t in zip(leaves_j, J.jax.tree.leaves(back), leaves_t):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, j.astype(np.float32))
        assert torch.equal(torch.from_numpy(b).to(t.dtype), t)


def test_dtypes_other_than_the_jax_packages_two_are_refused_by_name():
    cfg = t_configs.smoke_config("gemma2-2b").replace(dtype="float16")
    with pytest.raises(ValueError, match=r"ModelConfig\.dtype: .*float16"):
        TT.init_params(torch.Generator(), cfg)
    # the smoke reduction keeps float32, as the JAX one does
    assert t_configs.smoke_config("qwen3-32b").dtype == "float32"


# ---------------------------------------------------------------------------
# whole models at smoke size, from the JAX bf16 init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "gemma2-2b", "qwen3-32b"])
def test_bf16_smoke_model_within_twice_the_jax_bf16_envelope(J, arch):
    tc = t_configs.smoke_config(arch).replace(dtype="bfloat16")
    jc = J.smoke_config(arch).replace(dtype="bfloat16")
    jp = J.init(J.jax.random.PRNGKey(0), jc)
    jp32 = J.jax.tree.map(lambda a: a.astype(J.jnp.float32), jp)
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, size=(2, 48))
    jt = J.jnp.asarray(toks, J.jnp.int32)
    j_bf16 = np.asarray(J.jax.jit(lambda p, t: J.T.forward(p, jc, {"tokens": t})[0])(jp, jt))
    j_f32 = np.asarray(J.jax.jit(
        lambda p, t: J.T.forward(p, jc.replace(dtype="float32"), {"tokens": t})[0])(jp32, jt))
    env = float(np.abs(j_bf16 - j_f32).max())
    bar = 2 * env
    assert 0 < env < 0.1
    tp = tree_from_numpy(J.jax.tree.map(np.asarray, jp))
    t_bf16, _ = TT.forward(tp, tc, {"tokens": torch.as_tensor(toks)})
    assert t_bf16.dtype == torch.float32
    t_bf16 = t_bf16.numpy()
    assert np.abs(t_bf16 - j_bf16).max() <= bar, (np.abs(t_bf16 - j_bf16).max(), bar)
    assert np.abs(t_bf16 - j_f32).max() <= bar, (np.abs(t_bf16 - j_f32).max(), bar)
    top2 = np.sort(j_bf16, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > bar
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(t_bf16.argmax(-1)[clear], j_bf16.argmax(-1)[clear])
    # prefill against JAX prefill, then decode against the port's own forward
    s0 = 40
    lg, state = TT.prefill(tp, tc, {"tokens": torch.as_tensor(toks[:, :s0])}, max_len=64)
    j_lg = J.jax.jit(lambda p, t: J.T.prefill(p, jc, {"tokens": t}, max_len=64)[0])(jp, jt[:, :s0])
    assert np.abs(lg.numpy() - np.asarray(j_lg)).max() <= bar
    errs = [float(np.abs(lg.numpy() - t_bf16[:, s0 - 1]).max())]
    for i in range(s0, toks.shape[1]):
        lg, state = TT.decode_step(tp, tc, state, torch.as_tensor(toks[:, i]))
        errs.append(float(np.abs(lg.numpy() - t_bf16[:, i]).max()))
    assert max(errs) <= bar, (errs, bar)


def test_bf16_serve_batch_launches_nothing_on_the_cpu_and_restores_flags():
    tc = t_configs.smoke_config("gemma2-2b").replace(dtype="bfloat16")
    tp = TT.init_params(torch.Generator().manual_seed(0), tc)
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    seen = []
    real = TT.prefill

    def spy(*a, **k):
        seen.append((matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction))
        return real(*a, **k)

    for mod in (fa_mod, rg_mod, pm_mod):
        mod.reset_launches()
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        TT.prefill = spy
        gen = t_serve.serve_batch(tc, tp, torch.zeros(2, 8, dtype=torch.long), 3, device="cpu")
        assert seen == [(False, False)]
        assert matmul.allow_bf16_reduced_precision_reduction is True
    finally:
        TT.prefill = real
        matmul.allow_bf16_reduced_precision_reduction = saved
    assert tuple(gen.shape) == (2, 3)
    assert not any(v for m in (fa_mod, rg_mod, pm_mod) for v in m.LAUNCHES.values())


# ---------------------------------------------------------------------------
# on the card: each bf16 kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc and run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,keep_k,keep_n", PM_CASES)
def test_cuda_bf16_pruned_matmul_matches_plain(card, M, K, N, keep_k, keep_n):
    x, w, im, om = _pm_inputs(M, K, N, keep_k, keep_n)
    tx = torch.from_numpy(x).to(card, torch.bfloat16).requires_grad_(True)
    tw = torch.from_numpy(w).to(card, torch.bfloat16).requires_grad_(True)
    masks = [torch.from_numpy(m).to(card) for m in (im, om)]
    pm_mod.reset_launches()
    y = pruned_matmul(tx, tw, *masks)
    y.backward(torch.ones_like(y))
    y = y.detach()
    ref = pruned_matmul_plain(tx.detach(), tw.detach(), *masks)
    torch.cuda.synchronize()
    assert pm_mod.LAUNCHES == {k + mode: int(mode == "_bf16") for mode in ("", "_bf16")
                               for k in (pm_mod.FWD, pm_mod.DX, pm_mod.DW)}
    assert y.dtype == tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    err = float((y.float() - ref.float()).abs().max()) / max(float(ref.float().abs().max()), 1e-30)
    assert err <= PM_TOL
    if keep_n < N:
        assert float(y[:, keep_n:].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("blocks,shape,instances", [
    # the aligned instances (16-byte copies, ldmatrix / ldmatrix.trans)
    ((128, 128, 128), (2, 256, 576, 128), ("128x128,fwd", "128x128,dx", "128x128,dw")),
    ((64, 64, 64), (2, 200, 320, 136), ("64x64,fwd", "64x64,dx", "64x64,dw")),
    # K = 27: the generic instance (register loads) in every direction
    ((128, 128, 128), (2, 100, 27, 70), ("128x128,generic", "128x64,generic", "64x128,generic")),
])
def test_cuda_bf16_pruned_matmul_instances_match_plain(card, blocks, shape, instances):
    """Forward, dX and dW of each bf16 instance against the plain version,
    with per-row masks, pruned units exact zeros."""
    B, M, K, N = shape
    bm, bn, bk = blocks
    rng = np.random.default_rng(sum(shape))
    bf = torch.bfloat16
    to = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(card, dt)
    x, w = to(rng.normal(size=(B, M, K)), bf), to(rng.normal(size=(B, K, N)) / np.sqrt(K), bf)
    gy = to(rng.normal(size=(B, M, N)), bf)
    im, om, rm = (to(rng.random((B, n)) < 0.7) for n in (K, N, M))
    plans = (pm_mod.launch_plan(x, w, blocks), pm_mod.launch_plan(gy, w.transpose(1, 2), (bm, bk, bn)),
             pm_mod.launch_plan(x.transpose(1, 2), gy, (bk, bn, bm)))
    assert tuple(pl.instance for pl in plans) == instances
    outs = []
    for fn in (pruned_matmul, pruned_matmul_plain):
        tx, tw = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        kw = {"block_m": bm, "block_n": bn, "block_k": bk} if fn is pruned_matmul else {}
        pm_mod.reset_launches()
        y = fn(tx, tw, im, om, rm, **kw)
        y.backward(gy)
        outs.append((y.detach(), tx.grad, tw.grad))
    torch.cuda.synchronize()
    for a, r in zip(*outs):
        assert a.dtype == torch.bfloat16
        err = float((a.float() - r.float()).abs().max()) / float(r.float().abs().max())
        assert err <= PM_TOL, (instances, err)
    y, gx, gw = outs[0]
    assert float(y.float().abs().masked_select((om[:, None, :] == 0) | (rm[:, :, None] == 0)).max()) == 0.0
    assert float(gx.float().abs().masked_select((im[:, None, :] == 0) | (rm[:, :, None] == 0)).max()) == 0.0
    assert float(gw.float().abs().masked_select((im[:, :, None] == 0) | (om[:, None, :] == 0)).max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,d,kw", [
    *[(b, s, h, h, d, kw) for b, s, h, d, kw in FLASH_CASES],
    (2, 300, 16, 1, 256, {"window": 128, "softcap": 50.0}),
    (2, 129, 64, 8, 128, {}),
])
def test_cuda_bf16_flash_matches_plain(card, b, s, h, kv, d, kw):
    rng = np.random.default_rng(s + h)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, n, d)).astype(np.float32)).to(card, torch.bfloat16)
               for n in (h, kv, kv))
    fa_mod.reset_launches()
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_mod.LAUNCHES == {"flash_attention": 0, "flash_attention_bf16": 1}
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), atol=FLASH_TOL, rtol=FLASH_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,r", [(2, 3072, 4096), (2, 777, 1001), (3, 37, 100),
                                   # b 1; s 1; s not a multiple of a stage; r a multiple
                                   # of 8 (TMA) but not of a block; r under one block
                                   (1, 3072, 4096), (2, 1, 4096), (2, 100, 4096),
                                   (2, 300, 1000), (2, 300, 40),
                                   # r even but not a multiple of 8: 4-byte cp.async, no TMA
                                   (2, 300, 1002)])
def test_cuda_bf16_scan_bit_identical_to_plain(card, b, s, r):
    rng = np.random.default_rng(s)
    x = torch.from_numpy((rng.normal(size=(b, s, r)) * 0.1).astype(np.float32)).to(card, torch.bfloat16)
    a = torch.from_numpy(rng.uniform(0.85, 0.999, size=(b, s, r)).astype(np.float32)).to(card, torch.bfloat16)
    rg_mod.reset_launches()
    out = rg_lru_scan(x, a)
    ref = rg_lru_scan_plain(x, a)
    torch.cuda.synchronize()
    assert rg_mod.LAUNCHES == {"rg_lru_scan": 0, "rg_lru_scan_bf16": 1}
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2])
@pytest.mark.parametrize("which", ["x", "a"])
def test_cuda_bf16_scan_off_16_bytes_bit_identical_to_plain(card, which, offset):
    """An operand 2 or 4 bytes off 16-byte alignment (a view at storage
    offset 1 or 2) takes the kernel's path without TMA: element loads, or
    4-byte cp.async of element pairs."""
    b, s, r = 2, 300, 4096
    rng = np.random.default_rng(r)
    ops = {"x": (rng.normal(size=(b, s, r)) * 0.1).astype(np.float32),
           "a": rng.uniform(0.85, 0.999, size=(b, s, r)).astype(np.float32)}
    t = {k: torch.from_numpy(v).to(card, torch.bfloat16) for k, v in ops.items()}
    view = torch.empty(b * s * r + offset, dtype=torch.bfloat16, device=card)[offset:].view(b, s, r)
    t[which] = view.copy_(t[which])
    assert t[which].data_ptr() % 16 == 2 * offset
    rg_mod.reset_launches()
    out = rg_lru_scan(t["x"], t["a"])
    ref = rg_lru_scan_plain(t["x"], t["a"])
    torch.cuda.synchronize()
    assert rg_mod.LAUNCHES == {"rg_lru_scan": 0, "rg_lru_scan_bf16": 1}
    assert torch.equal(out, ref)
