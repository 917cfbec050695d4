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
    SPLIT_TOL,
    block_keep_count,
    check_blocks,
    keep_info,
    launch_plan,
    pruned_matmul,
    pruned_matmul_plain,
    pruned_matmul_split_plain,
    slice_bounds,
    split_factor,
    tile_shape,
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


# ---------------------------------------------------------------------------
# the split-K schedule (host side of the CUDA kernel), on the CPU
# ---------------------------------------------------------------------------

H100_SMS = 132


@pytest.mark.parametrize("split", [1, 2, 3, 7, 32])
@pytest.mark.parametrize("L,block", [(300, 128), (4099, 128), (640, 64), (27, 128)])
def test_slices_cover_every_live_block_once_in_order(L, block, split):
    rng = np.random.default_rng(L + split)
    masks = (rng.random((4, L)) < np.array([[0.9], [0.3], [0.02], [0.0]])).astype(np.float32)
    masks[0, -1] = 1.0                      # the ragged last block is live in row 0
    _, live, count = keep_info(_t(masks), block)
    bounds = slice_bounds(count, split)
    assert tuple(bounds.shape) == (4, split, 2)
    assert int(count[3]) == 0               # a row with no live K block
    for b in range(4):
        n = int(count[b])
        walked = []
        for s in range(split):
            lo, hi = (int(v) for v in bounds[b, s])
            assert 0 <= lo <= hi <= n
            walked += live[b, lo:hi].tolist()
        assert walked == live[b, :n].tolist()          # every live block once, ascending
        assert walked == sorted(set(walked))
        sizes = [int(bounds[b, s, 1] - bounds[b, s, 0]) for s in range(split)]
        assert max(sizes) - min(sizes) <= 1             # balanced slices


@pytest.mark.parametrize("B,M,N,K", [
    (10, 2048, 2304, 256),      # conv5 dX: 2880 tiles of 128x128, 22 waves on 132 SMs
    (10, 512, 4608, 512),       # conv8 dX
    (10, 4608, 512, 512),       # conv8 dW
    (1, 132 * 128, 128, 4096),  # exactly one full wave, deep contraction
])
def test_split_is_one_when_the_output_tiles_fill_the_card(B, M, N, K):
    tm, tn = tile_shape(M, N, 128, 128)
    assert B * -(-M // tm) * -(-N // tn) >= H100_SMS
    assert split_factor(B, M, N, K, (128, 128, 128), H100_SMS) == 1


def _makespan(B, M, N, K, S):
    """The split rule's cost: block times on the busiest SM x K blocks a slice walks."""
    tm, tn = tile_shape(M, N, 128, 128)
    tiles = B * -(-M // tm) * -(-N // tn)
    return -(-tiles * S // H100_SMS) * -(-(-(-K // 128)) // S)


@pytest.mark.parametrize("B,M,N,K,tiles,gain", [
    (10, 27, 64, 32768, (64, 64), 8),       # conv0 dW: x^T [27, 32768] @ g [32768, 64]
    (10, 576, 64, 32768, (128, 64), 2),     # conv1 dW
    (10, 128, 512, 4608, (128, 128), 2),    # conv10 forward
    (10, 512, 512, 4608, (128, 128), 1.3),  # conv8 forward: 160 tiles, a second wave of 28
])
def test_split_covers_the_thin_deep_products(B, M, N, K, tiles, gain):
    assert tile_shape(M, N, 128, 128) == tiles
    S = split_factor(B, M, N, K, (128, 128, 128), H100_SMS)
    assert S > 1
    assert K / S >= 256 and S <= -(-K // 128)          # each slice walks >= 256 rows
    assert _makespan(B, M, N, K, S) * gain <= _makespan(B, M, N, K, 1)
    # the fewest slices within the tolerance of the best makespan
    best = min(_makespan(B, M, N, K, s) for s in range(1, min(32, K // 256) + 1))
    assert _makespan(B, M, N, K, S) <= SPLIT_TOL * best
    assert all(_makespan(B, M, N, K, s) > SPLIT_TOL * best for s in range(1, S))


def test_launch_plan_picks_the_instance_from_strides_and_alignment():
    B, M, K, N = 2, 256, 576, 64
    x, w, g = torch.zeros(B, M, K), torch.zeros(B, K, N), torch.zeros(B, M, N)
    plan = lambda a, b_, blk=(128, 128, 128): launch_plan(a, b_, blk, sms=H100_SMS)
    assert plan(x, w).instance == "128x64,fwd"
    assert plan(g, w.transpose(1, 2)).instance == "128x128,dx"
    dw = plan(x.transpose(1, 2), g)
    assert dw.instance == "128x64,dw" and dw.split == 1
    # a stride-0 shared operand keeps the vector instance
    assert plan(x, torch.zeros(K, N).expand(B, K, N)).instance == "128x64,fwd"
    # K = 27 (conv0), an unaligned pointer, or an odd stride: the generic instance
    assert plan(torch.zeros(B, M, 27), torch.zeros(B, 27, N)).instance == "128x64,generic"
    assert plan(torch.zeros(B, M, K + 1)[:, :, 1:], w).instance == "128x64,generic"
    assert plan(torch.zeros(B, K, M + 2)[:, :, :M].transpose(1, 2), w).instance == "128x64,generic"
    # 64-wide blocks give 64-wide tiles; the split needs a thin, deep product
    assert plan(x, w, (64, 64, 64)).instance == "64x64,fwd"
    deep = plan(torch.zeros(10, 32768, 27).transpose(1, 2), torch.zeros(10, 32768, 64))
    assert deep.split > 1 and deep.workspace_bytes == 4 * deep.split * 10 * 27 * 64
    # bf16 operands: the same instances under the 8-element rule (16-byte
    # copies of 8 bf16), the split and the float32 workspace as in float32
    z = lambda *shape: torch.zeros(*shape, dtype=torch.bfloat16)
    xb, wb, gb = z(B, M, K), z(B, K, N), z(B, M, N)
    assert plan(xb, wb).instance == "128x64,fwd"
    assert plan(gb, wb.transpose(1, 2)).instance == "128x128,dx"
    assert plan(xb.transpose(1, 2), gb).instance == "128x64,dw"
    assert plan(xb, z(K, N).expand(B, K, N)).instance == "128x64,fwd"
    assert plan(xb, wb, (64, 64, 64)).instance == "64x64,fwd"
    # K = 27, an unaligned pointer, a stride that is a multiple of 4 but not
    # of 8, or a fast extent that is: the generic instance
    assert plan(z(B, M, 27), z(B, 27, N)).instance == "128x64,generic"
    assert plan(z(B, M, K + 1)[:, :, 1:], wb).instance == "128x64,generic"
    assert plan(z(B, M, K + 4)[:, :, :K], wb).instance == "128x64,generic"
    assert plan(z(B, M, K + 8)[:, :, :K], wb).instance == "128x64,fwd"
    assert plan(z(B, M, 580), z(B, 580, N)).instance == "128x64,generic"
    assert plan(z(B, K, M + 4)[:, :, :M].transpose(1, 2), wb).instance == "128x64,generic"
    deep_b = plan(z(10, 32768, 27).transpose(1, 2), z(10, 32768, 64))
    assert (deep_b.split, deep_b.workspace_bytes) == (deep.split, deep.workspace_bytes)


def _split_case(seed, B, M, K, N):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, M, K)).astype(np.float32)
    w = (rng.normal(size=(B, K, N)) / np.sqrt(K)).astype(np.float32)
    keep = np.array([[1.0], [0.5], [0.1], [0.0]])[:B]       # different live counts per row
    im = (rng.random((B, K)) < keep).astype(np.float32)     # the last row: no live K block
    om = (rng.random((B, N)) < 0.6).astype(np.float32)
    rm = (rng.random((B, M)) < 0.8).astype(np.float32)
    om[:, 0] = rm[:, 0] = 1.0
    return x, w, im, om, rm


SPLIT_CASES = [
    # seed, (B, M, K, N), blocks, split
    (0, (4, 70, 1000, 90), (64, 64, 64), 5),          # ragged K, N and M
    (1, (4, 27, 2500, 64), (128, 128, 128), 7),       # conv0-like dW: thin output
    (2, (3, 130, 777, 130), (256, 128, 64), 3),
    (3, (2, 64, 300, 64), (64, 64, 64), 8),           # more slices than some rows' blocks
]


@pytest.mark.parametrize("seed,shape,blocks,split", SPLIT_CASES)
def test_split_schedule_plain_matches_the_plain_version(seed, shape, blocks, split):
    x, w, im, om, rm = _split_case(seed, *shape)
    ys = pruned_matmul_split_plain(_t(x), _t(w), _t(im), _t(om), _t(rm), blocks, split)
    y1 = pruned_matmul_split_plain(_t(x), _t(w), _t(im), _t(om), _t(rm), blocks, 1)
    yp = pruned_matmul_plain(_t(x), _t(w), _t(im), _t(om), _t(rm))
    np.testing.assert_allclose(ys.numpy(), yp.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y1.numpy(), yp.numpy(), atol=1e-5, rtol=1e-5)
    if shape[0] == 4:
        assert np.abs(ys.numpy()[3]).max() == 0.0      # no live K block: exact zeros
    assert np.abs(ys.numpy()[np.broadcast_to(om[:, None, :] == 0, ys.shape)]).max(initial=0.0) == 0.0


@pytest.mark.parametrize("seed,shape,blocks,split", SPLIT_CASES[:3])
def test_split_schedule_plain_matches_jax_kernel(seed, shape, blocks, split):
    x, w, im, om, rm = _split_case(seed, *shape)
    bm, bn, bk = blocks
    ys = pruned_matmul_split_plain(_t(x), _t(w), _t(im), _t(om), _t(rm), blocks, split).numpy()
    for b in range(shape[0]):
        yj = np.asarray(j_pm(jnp.asarray(x[b]), jnp.asarray(w[b]), jnp.asarray(im[b]),
                             jnp.asarray(om[b]), jnp.asarray(rm[b]), block_m=bm, block_n=bn,
                             block_k=bk, interpret=True))
        np.testing.assert_allclose(ys[b], yj, atol=TOL, rtol=TOL)


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
