"""The port's VGG (``repro_torch.models.cnn``) against the JAX package's.

Same params (the JAX ``init_cnn`` draw carried over by ``convert``), same
numpy inputs: dense and block_skip logits and gradients within 1e-4 of JAX
``cnn_apply`` / ``jax.grad``, the worker-stacked form against ``jax.vmap``,
and the host metadata (unit space, FLOPs, block ledger) exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.aggregation import coordinate_mask
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy
from repro_torch.models import cnn as tcnn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread beats a pool of them,
    which only contends with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-4
PLAN = [16, "M", 32]


def _cfgs(plan=PLAN, image=8):
    return (jcnn.vgg_config("t", plan, num_classes=10, image_size=image),
            tcnn.vgg_config("t", plan, num_classes=10, image_size=image))


def _base(jcfg, seed=0):
    return {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg).items()}


def _prefix_masks(names, params, keep):
    out = {}
    for name in names:
        n = params[f"{name}/bn_g"].shape[0]
        m = np.zeros(n, np.float32)
        m[: max(2, int(round(n * keep)))] = 1.0
        out[name] = m
    return out


def _masked(jcfg, params, um):
    space, unit_map = jcnn.build_unit_space(jcfg, params)
    index = {l.name: np.flatnonzero(um[l.name]) for l in space.layers}
    shapes = {k: v.shape for k, v in params.items()}
    return {k: (v * coordinate_mask(k, index, unit_map, shapes)).astype(np.float32)
            for k, v in params.items()}


def _x(n=4, image=8, seed=1):
    return np.random.default_rng(seed).normal(size=(n, image, image, 3)).astype(np.float32)


def _loss_t(logits):
    return torch.log_softmax(logits, -1).sum()


def _loss_j(logits):
    return jnp.sum(jax.nn.log_softmax(logits))


@pytest.mark.parametrize("plan", [PLAN, [16, "M", 32, 32, "M"]])
def test_dense_logits_and_grads_match_jax(plan):
    jcfg, tcfg = _cfgs(plan)
    base = _base(jcfg)
    x = _x()
    lj = jcnn.cnn_apply({k: jnp.asarray(v) for k, v in base.items()}, jcfg, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(base).items()}
    lt = tcnn.cnn_apply(tp, tcfg, torch.as_tensor(x))
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    gj = jax.jit(jax.grad(lambda p: _loss_j(jcnn.cnn_apply(p, jcfg, jnp.asarray(x)))))(
        {k: jnp.asarray(v) for k, v in base.items()})
    gt = torch.autograd.grad(_loss_t(lt), list(tp.values()))
    for k, g in zip(tp, gt):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[k]), atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("keep", [1.0, 0.5, 0.25])
def test_block_skip_matches_jax_dense_and_jax_block_skip(keep):
    jcfg, tcfg = _cfgs()
    base = _base(jcfg)
    um = _prefix_masks(jcnn.prunable_layer_names(jcfg), base, keep)
    pm = _masked(jcfg, base, um)
    x = _x()
    jp = {k: jnp.asarray(v) for k, v in pm.items()}
    umj = {k: jnp.asarray(v) for k, v in um.items()}
    dense_j = jcnn.cnn_apply(jp, jcfg, jnp.asarray(x))
    bs_j = jcnn.cnn_apply(jp, jcfg, jnp.asarray(x), compute="block_skip", unit_masks=umj,
                          blocks=(128, 8, 8), interpret=True)
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(pm).items()}
    umt = {k: torch.as_tensor(v) for k, v in um.items()}
    bs_t = tcnn.cnn_apply(tp, tcfg, torch.as_tensor(x), compute="block_skip", unit_masks=umt)
    np.testing.assert_allclose(bs_t.detach().numpy(), np.asarray(dense_j), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(bs_t.detach().numpy(), np.asarray(bs_j), atol=TOL, rtol=TOL)

    gj = jax.jit(jax.grad(lambda p: _loss_j(jcnn.cnn_apply(p, jcfg, jnp.asarray(x)))))(jp)
    gt = torch.autograd.grad(_loss_t(bs_t), list(tp.values()))
    for k, g in zip(tp, gt):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[k]), atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("compute", ["dense", "block_skip"])
def test_worker_stack_matches_jax_vmap(compute):
    """[B, ...] params and images with per-row masks == vmapped JAX apply."""
    jcfg, tcfg = _cfgs()
    names = jcnn.prunable_layer_names(jcfg)
    rows_p, rows_m = [], []
    for b, keep in enumerate((1.0, 0.5, 0.25)):
        base = _base(jcfg, seed=b)
        um = _prefix_masks(names, base, keep)
        rows_p.append(_masked(jcfg, base, um))
        rows_m.append(um)
    stack = {k: np.stack([p[k] for p in rows_p]) for k in rows_p[0]}
    masks = {k: np.stack([m[k] for m in rows_m]) for k in names}
    xs = np.stack([_x(seed=10 + b) for b in range(3)])
    lj = jax.vmap(lambda p, q: jcnn.cnn_apply(p, jcfg, q))(
        {k: jnp.asarray(v) for k, v in stack.items()}, jnp.asarray(xs))
    kw = {} if compute == "dense" else {
        "compute": "block_skip", "unit_masks": {k: torch.as_tensor(v) for k, v in masks.items()}}
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(stack).items()}
    lt = tcnn.cnn_apply(tp, tcfg, torch.as_tensor(xs), **kw)
    assert lt.shape == (3, 4, 10)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj), atol=TOL, rtol=TOL)
    gj = jax.jit(jax.grad(lambda p: _loss_j(jax.vmap(lambda a, q: jcnn.cnn_apply(a, jcfg, q))(
        p, jnp.asarray(xs)))))({k: jnp.asarray(v) for k, v in stack.items()})
    gt = torch.autograd.grad(_loss_t(lt), list(tp.values()))
    for k, g in zip(tp, gt):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[k]), atol=TOL, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("cin,hw", [(3, 8), (5, 4)])
def test_unfold_is_channel_major_like_conv_patches(cin, hw):
    x = np.random.default_rng(cin).normal(size=(2, hw, hw, cin)).astype(np.float32)
    pj = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (3, 3), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    pt = F.unfold(torch.as_tensor(x).permute(0, 3, 1, 2), 3, padding=1)   # [b, C*9, L]
    pt = pt.transpose(1, 2).reshape(2, hw, hw, cin * 9)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_init_cnn_law_and_layout():
    jcfg = jcnn.VGG16_CIFAR
    tcfg = tcnn.VGG16_CIFAR
    jp = jax.eval_shape(lambda: jcnn.init_cnn(jax.random.PRNGKey(0), jcfg))
    tp = tcnn.init_cnn(tcfg, torch.Generator().manual_seed(0))
    assert sorted(tp) == sorted(jp)
    small_j, small_t = _cfgs()     # same insertion order as the JAX dict
    assert list(tcnn.init_cnn(small_t, torch.Generator().manual_seed(0))) == list(_base(small_j))
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
    for k, v in tp.items():
        if k.endswith("/w"):
            fan_in = int(np.prod(v.shape[:-1]))
            scale = np.sqrt((2.0 if k != "fc/w" else 1.0) / fan_in)
            assert float(v.abs().max()) <= 2.0 * scale * (1 + 1e-6)
        elif k.endswith("bn_g"):
            assert torch.equal(v, torch.ones_like(v))
        else:
            assert torch.equal(v, torch.zeros_like(v))
    again = tcnn.init_cnn(tcfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], tp[k]) for k in tp)
    w = tp["conv12/w"].flatten() / np.sqrt(2.0 / (9 * 512))
    assert abs(float(w.std()) - 0.8796) < 0.01     # std of N(0,1) truncated at ±2


@pytest.mark.parametrize("which", ["vgg16", "small"])
def test_unit_space_flops_and_wiring_equal_jax(which):
    if which == "vgg16":
        jcfg, tcfg = jcnn.VGG16_CIFAR, tcnn.VGG16_CIFAR
    else:
        jcfg, tcfg = _cfgs([16, "M", 32, 32, "M"])
    shapes = {k: np.zeros(v.shape, np.float32) for k, v in jax.eval_shape(
        lambda: jcnn.init_cnn(jax.random.PRNGKey(0), jcfg)).items()}
    js, jm = jcnn.build_unit_space(jcfg, shapes)
    ts, tm = tcnn.build_unit_space(tcfg, params_from_numpy(shapes))
    assert [dataclass_tuple(l) for l in js.layers] == [dataclass_tuple(l) for l in ts.layers]
    assert js.fixed_params == ts.fixed_params
    assert {k: list(v) for k, v in jm.items()} == {k: list(v) for k, v in tm.items()}
    assert list(jm) == list(tm)
    assert jcnn.cnn_flops(shapes, jcfg) == tcnn.cnn_flops(shapes, tcfg)
    assert jcnn.conv_mask_wiring(jcfg) == tcnn.conv_mask_wiring(tcfg)
    assert jcnn.prunable_layer_names(jcfg) == tcnn.prunable_layer_names(tcfg)
    rng = np.random.default_rng(0)
    for blocks in ((128, 128, 128), (128, 8, 8), (64, 64, 64)):
        um = {l.name: (rng.random(l.num_units) < 0.4).astype(np.float32) for l in js.layers}
        assert jcnn.cnn_block_compute(jcfg, um, blocks) == tcnn.cnn_block_compute(tcfg, um, blocks)
    full = {l.name: np.ones(l.num_units, np.float32) for l in js.layers}
    assert tcnn.cnn_block_compute(tcfg, full)["blocks"] == tcnn.cnn_block_compute(tcfg, full)["blocks_total"]


def dataclass_tuple(l):
    return (l.name, l.num_units, l.unit_param_cost, l.min_units)


def test_extract_bn_scales_equal_jax():
    jcfg, tcfg = _cfgs()
    base = _base(jcfg)
    base["conv0/bn_g"] = np.random.default_rng(0).normal(size=16).astype(np.float32)
    js = jcnn.extract_bn_scales(base, jcfg)
    ts = tcnn.extract_bn_scales(params_from_numpy(base), tcfg)
    assert list(js) == list(ts)
    for k in js:
        assert ts[k].dtype == np.float64
        np.testing.assert_array_equal(ts[k], js[k])
