"""The port's block-skip matmul against the JAX package's Pallas kernel.

On the CPU the port's ``pruned_matmul`` runs its plain PyTorch version; it is
held against JAX ``pruned_matmul(interpret=True)`` (the Pallas kernel body in
interpret mode), ``kernels/ref.py:pruned_matmul_ref`` and the kernel's custom
VJP, on the cases of tests/test_kernels.py and tests/test_blockskip.py.
f32 tolerance 1e-4 (atol = rtol, the reference's bar); pruned units must
be exactly 0.  Tests marked ``cuda`` need the card and skip elsewhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pruned_matmul import block_keep_count as j_block_keep_count
from repro.kernels.pruned_matmul import pruned_matmul as j_pm
from repro.kernels.ref import pruned_matmul_ref as j_ref
from repro_torch.kernels import pruned_matmul as pm_mod
from repro_torch.kernels.pruned_matmul import (
    LAUNCHES,
    block_keep_count,
    check_blocks,
    keep_info,
    pruned_matmul,
    pruned_matmul_plain,
)
from repro_torch.kernels.ref import pruned_matmul_ref

TOL = 1e-4


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _prefix(n, k):
    m = np.zeros(n, np.float32)
    m[:k] = 1.0
    return m


@pytest.mark.parametrize(
    "M,K,N,keep_k,keep_n",
    [
        (128, 256, 128, 256, 128),      # nothing pruned
        (256, 512, 384, 300, 200),      # CIG prefix pruning
        (128, 384, 256, 128, 64),       # heavy pruning (blocks skipped)
        (128, 256, 128, 1, 1),          # extreme
    ],
)
def test_prefix_masks_match_jax_kernel_and_ref(M, K, N, keep_k, keep_n):
    rng = np.random.default_rng(M + K + N + keep_k)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    im, om = _prefix(K, keep_k), _prefix(N, keep_n)
    y = pruned_matmul(_t(x), _t(w), _t(im), _t(om)).numpy()
    yj = np.asarray(j_pm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(im), jnp.asarray(om),
                         interpret=True))
    np.testing.assert_allclose(y, yj, atol=TOL, rtol=TOL)
    ref_j = np.asarray(j_ref(jnp.asarray(x), jnp.asarray(w), jnp.arange(keep_k), jnp.arange(keep_n)))
    ref_t = pruned_matmul_ref(_t(x), _t(w), torch.arange(keep_k), torch.arange(keep_n)).numpy()
    np.testing.assert_allclose(ref_t, ref_j, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(y[:, :keep_n], ref_t, atol=TOL, rtol=TOL)
    if keep_n < N:
        assert np.abs(y[:, keep_n:]).max() == 0.0


@pytest.mark.parametrize("M,K,N", [(200, 300, 130), (1, 1, 1), (100, 128, 129)])
def test_ragged_shapes_match_jax_kernel(M, K, N):
    rng = np.random.default_rng(M)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    im = (rng.random(K) < 0.7).astype(np.float32)
    om = (rng.random(N) < 0.7).astype(np.float32)
    im[0] = om[0] = 1.0
    y = pruned_matmul(_t(x), _t(w), _t(im), _t(om)).numpy()
    yj = np.asarray(j_pm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(im), jnp.asarray(om),
                         interpret=True))
    assert y.shape == (M, N)
    np.testing.assert_allclose(y, yj, atol=TOL, rtol=TOL)
    assert np.abs(y[:, om == 0]).max(initial=0.0) == 0.0


def test_row_mask_matches_jax_kernel():
    rng = np.random.default_rng(5)
    M, K, N = 160, 128, 128
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    row = _prefix(M, 50)
    ones_k, ones_n = np.ones(K, np.float32), np.ones(N, np.float32)
    y = pruned_matmul(_t(x), _t(w), _t(ones_k), _t(ones_n), _t(row)).numpy()
    yj = np.asarray(j_pm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ones_k),
                         jnp.asarray(ones_n), jnp.asarray(row), interpret=True))
    np.testing.assert_allclose(y, yj, atol=TOL, rtol=TOL)
    assert np.abs(y[50:]).max() == 0.0


def test_scattered_masks_match_jax_kernel():
    rng = np.random.default_rng(0)
    K, N = 384, 256
    x = rng.normal(size=(128, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    im = (rng.random(K) < 0.6).astype(np.float32)
    om = (rng.random(N) < 0.5).astype(np.float32)
    y = pruned_matmul(_t(x), _t(w), _t(im), _t(om)).numpy()
    yj = np.asarray(j_pm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(im), jnp.asarray(om),
                         interpret=True))
    np.testing.assert_allclose(y, yj, atol=TOL, rtol=TOL)


@pytest.mark.parametrize(
    "M,K,N,blocks",
    [
        (128, 256, 128, (128, 128, 128)),
        (200, 300, 130, (128, 128, 128)),
        (96, 144, 80, (32, 16, 16)),
    ],
)
def test_gradients_match_jax_custom_vjp(M, K, N, blocks):
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    im = (rng.random(K) < 0.5).astype(np.float32)
    om = (rng.random(N) < 0.5).astype(np.float32)
    im[0] = om[0] = 1.0
    bm, bn, bk = blocks

    def fj(x_, w_):
        y = j_pm(x_, w_, jnp.asarray(im), jnp.asarray(om), block_m=bm, block_n=bn,
                 block_k=bk, interpret=True)
        return jnp.sum(jnp.sin(y))

    gxj, gwj = jax.grad(fj, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    loss = torch.sin(pruned_matmul(xt, wt, _t(im), _t(om), block_m=bm, block_n=bn,
                                   block_k=bk)).sum()
    np.testing.assert_allclose(loss.item(), float(fj(jnp.asarray(x), jnp.asarray(w))), rtol=1e-5)
    gx, gw = torch.autograd.grad(loss, (xt, wt))
    np.testing.assert_allclose(gx.numpy(), np.asarray(gxj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(gwj), atol=TOL, rtol=TOL)
    assert np.abs(gx.numpy()[:, im == 0]).max() == 0.0
    assert np.abs(gw.numpy()[im == 0, :]).max() == 0.0
    assert np.abs(gw.numpy()[:, om == 0]).max() == 0.0


def test_batched_per_row_masks_match_jax_vmap():
    rng = np.random.default_rng(7)
    B, M, K, N = 3, 40, 96, 48
    xs = rng.normal(size=(B, M, K)).astype(np.float32)
    ws = (rng.normal(size=(B, K, N)) * 0.05).astype(np.float32)
    ims = np.stack([_prefix(K, max(1, int(K * k))) for k in (1.0, 0.5, 0.25)])
    oms = np.stack([_prefix(N, max(1, int(N * k))) for k in (1.0, 0.5, 0.25)])
    f = jax.vmap(lambda a, b_, c, d: j_pm(a, b_, c, d, block_m=32, block_n=16, block_k=16,
                                          interpret=True))
    yj = f(jnp.asarray(xs), jnp.asarray(ws), jnp.asarray(ims), jnp.asarray(oms))
    gwj = jax.grad(lambda w_: jnp.sum(f(jnp.asarray(xs), w_, jnp.asarray(ims),
                                        jnp.asarray(oms)) ** 2))(jnp.asarray(ws))
    wt = _t(ws).requires_grad_(True)
    y = pruned_matmul(_t(xs), wt, _t(ims), _t(oms))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), atol=TOL, rtol=TOL)
    (gw,) = torch.autograd.grad((y ** 2).sum(), (wt,))
    np.testing.assert_allclose(gw.numpy(), np.asarray(gwj), atol=TOL, rtol=TOL)
    assert np.abs(gw.numpy()[2][:, oms[2] == 0]).max() == 0.0


def test_cpu_tensors_take_the_plain_version_without_launching():
    rng = np.random.default_rng(1)
    x, w = _t(rng.normal(size=(2, 5, 7))), _t(rng.normal(size=(2, 7, 4)))
    im, om = _t(np.ones((2, 7))), _t([[1, 0, 1, 0], [0, 1, 1, 1]])
    before = dict(LAUNCHES)
    y = pruned_matmul(x, w, im, om, block_m=8, block_n=8, block_k=8)
    assert LAUNCHES == before
    assert torch.equal(y, pruned_matmul_plain(x, w, im, om))


def test_non_cpu_non_cuda_tensor_is_refused():
    x = torch.empty((4, 4), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pruned_matmul(x, x, torch.ones(4, device="meta"), torch.ones(4, device="meta"))


@pytest.mark.parametrize("blocks", [(128, 8, 8), (32, 16, 16), (100, 128, 128), (0, 64, 64)])
def test_blocks_the_kernel_cannot_take_name_compute_blocks(blocks):
    with pytest.raises(ValueError, match="compute_blocks"):
        check_blocks(blocks)


@pytest.mark.parametrize("blocks", [(128, 128, 128), (64, 64, 64), (256, 128, 64)])
def test_blocks_the_kernel_takes(blocks):
    assert check_blocks(blocks) == blocks


@pytest.mark.parametrize("L,block", [(300, 128), (27, 128), (512, 64), (129, 128)])
def test_device_keep_flags_match_host_block_count(L, block):
    rng = np.random.default_rng(L + block)
    masks = (rng.random((3, L)) < 0.3).astype(np.float32)
    masks[1] = 0.0
    masks[2, -1] = 1.0
    flags, live, count = keep_info(_t(masks), block)
    for b in range(3):
        assert int(count[b]) == block_keep_count(masks[b], block) == j_block_keep_count(masks[b], block)
        expect = [i for i in range(flags.shape[1]) if masks[b, i * block:(i + 1) * block].sum() > 0]
        assert live[b, : int(count[b])].tolist() == expect
        assert flags[b].tolist() == [int(i in expect) for i in range(flags.shape[1])]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode); run chip_smoke.py on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_with_exact_zeros(cuda_device):
    rng = np.random.default_rng(3)
    B, M, K, N = 3, 200, 300, 130
    x = torch.as_tensor(rng.normal(size=(B, M, K)), dtype=torch.float32, device=cuda_device)
    w = torch.as_tensor(rng.normal(size=(B, K, N)) * 0.05, dtype=torch.float32, device=cuda_device)
    im = torch.as_tensor((rng.random((B, K)) < 0.5), dtype=torch.float32, device=cuda_device)
    om = torch.as_tensor((rng.random((B, N)) < 0.5), dtype=torch.float32, device=cuda_device)
    x.requires_grad_(True)
    w.requires_grad_(True)
    before = LAUNCHES[pm_mod.FWD]
    y = pruned_matmul(x, w, im, om)
    gx, gw = torch.autograd.grad(y.square().sum(), (x, w))
    yr = pruned_matmul_plain(x, w, im, om)
    rx, rw = torch.autograd.grad(yr.square().sum(), (x, w))
    assert LAUNCHES[pm_mod.FWD] == before + 1
    for a, b in ((y, yr), (gx, rx), (gw, rw)):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)
    assert gw.masked_select((om == 0).unsqueeze(1).expand_as(gw)).abs().max() == 0.0
