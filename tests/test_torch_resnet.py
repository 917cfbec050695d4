"""The port's ResNet (``repro_torch.models.cnn``) against the JAX package's.

Host metadata exactly equal at RESNET20_SMALL and RESNET50_TINY (shapes from
``jax.eval_shape``); forward logits and every gradient within 1e-4 for the
dense and block_skip paths against JAX's dense on masked params, unbatched
and as worker stacks, on four nets: RESNET20_SMALL at 32x32 (the stride-2
3x3 SAME pad), a bottleneck net, a basic-block net whose stride-2 block has
no shortcut conv (the ``x[::2, ::2]`` subsample), and an odd input size.
The same JAX function is also evaluated in float64 (``jax.enable_x64``):
the port's float32 result must lie within 1e-4 of it everywhere, and within
1e-4 of JAX's float32 result wherever that one lies within 5e-5 of it.  (At
RESNET20_SMALL's stage 0 the reference's float32 gradient strays past 1e-4
from its own float64 value.)
Then whole ResNet simulations against the reference's masked engine under
ROADMAP's parity contract, and one tiny run against the reference's own
block_skip (Pallas interpret mode) that pins the FLOPs/blocks ledger.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.aggregation import coordinate_mask
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import run_simulation as j_run
from repro.data.synthetic import SyntheticImageTask as JTask
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import run_simulation as t_run
from repro_torch.data.synthetic import SyntheticImageTask as TTask
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

# name -> (resnet_config args, image size)
NETS = {
    "resnet20_small": (("r20", 16, [(2, 16), (2, 32), (2, 64)]),
                       dict(num_classes=10, image_size=32, bottleneck=False)),
    "bottleneck": (("t", 8, [(1, 8), (1, 16)]), dict(num_classes=10, image_size=8)),
    "basic_no_sc": (("t", 8, [(1, 8), (1, 8)]), dict(num_classes=10, image_size=8, bottleneck=False)),
    "odd_input": (("t", 8, [(1, 8), (1, 16)]), dict(num_classes=10, image_size=9)),
}


def _cfgs(net):
    args, kw = NETS[net]
    return jcnn.resnet_config(*args, **kw), tcnn.resnet_config(*args, **kw)


def _base(jcfg, seed=0):
    return {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg).items()}


def _prefix_masks(jcfg, params, keep):
    out = {}
    for name in jcnn.prunable_layer_names(jcfg):
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


def _x(n, image, seed):
    return np.random.default_rng(seed).normal(size=(n, image, image, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# SAME padding at stride 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,k,s", [(8, 3, 2), (9, 3, 2), (32, 3, 2), (8, 1, 2), (9, 1, 2),
                                      (7, 3, 1), (5, 3, 3)])
def test_same_pads_and_strided_patches_equal_jax(size, k, s):
    """JAX's SAME split (the smaller half before) and the padded, strided
    im2col equal ``conv_general_dilated_patches`` bit for bit."""
    lo, hi = jax.lax.padtype_to_pads((size,), (k,), (s,), "SAME")[0]
    assert tcnn._same_pads(size, k, s) == (lo, hi)
    x = np.random.default_rng(size + k + s).normal(size=(2, size, size, 5)).astype(np.float32)
    pj = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (k, k), (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    xp, pad = tcnn._pad_same(torch.as_tensor(x).permute(0, 3, 1, 2), k, k, s)
    pt = F.unfold(xp, k, padding=pad, stride=s)
    o = -(-size // s)
    pt = pt.transpose(1, 2).reshape(2, o, o, 5 * k * k)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


# ---------------------------------------------------------------------------
# host metadata at the paper's nets
# ---------------------------------------------------------------------------

def _pair_big(which):
    return {"r20": (jcnn.RESNET20_SMALL, tcnn.RESNET20_SMALL),
            "r50": (jcnn.RESNET50_TINY, tcnn.RESNET50_TINY)}[which]


def _shapes(jcfg):
    return {k: np.zeros(v.shape, np.float32) for k, v in jax.eval_shape(
        lambda: jcnn.init_cnn(jax.random.PRNGKey(0), jcfg)).items()}


@pytest.mark.parametrize("which", ["r20", "r50"])
def test_wiring_prunable_convs_and_geoms_equal_jax(which):
    jcfg, tcfg = _pair_big(which)
    assert jcnn.conv_mask_wiring(jcfg) == tcnn.conv_mask_wiring(tcfg)
    assert jcnn._prunable_convs(jcfg) == tcnn._prunable_convs(tcfg)
    assert jcnn._base_conv_geoms(jcfg) == tcnn._base_conv_geoms(tcfg)
    assert jcnn.prunable_layer_names(jcfg) == tcnn.prunable_layer_names(tcfg)


@pytest.mark.parametrize("which", ["r20", "r50"])
def test_unit_space_and_flops_equal_jax(which):
    jcfg, tcfg = _pair_big(which)
    shapes = _shapes(jcfg)
    js, jm = jcnn.build_unit_space(jcfg, shapes)
    ts, tm = tcnn.build_unit_space(tcfg, params_from_numpy(shapes))
    assert [(l.name, l.num_units, l.unit_param_cost, l.min_units) for l in js.layers] == \
        [(l.name, l.num_units, l.unit_param_cost, l.min_units) for l in ts.layers]
    assert js.fixed_params == ts.fixed_params
    assert {k: list(v) for k, v in jm.items()} == {k: list(v) for k, v in tm.items()}
    assert list(jm) == list(tm)
    full = {k: v.shape for k, v in shapes.items()}
    assert jcnn.cnn_flops_from_shapes(full, jcfg) == tcnn.cnn_flops_from_shapes(full, tcfg)
    # a reconfigured sub-model: every prunable layer cut to 3 units
    from repro.core.aggregation import subparam_shapes

    idx = {l.name: np.arange(3) for l in js.layers}
    sub = subparam_shapes(idx, jm, full)
    assert jcnn.cnn_flops_from_shapes(sub, jcfg) == tcnn.cnn_flops_from_shapes(sub, tcfg)


@pytest.mark.parametrize("which", ["r20", "r50"])
def test_block_compute_equal_jax(which):
    jcfg, tcfg = _pair_big(which)
    js, _ = jcnn.build_unit_space(jcfg, _shapes(jcfg))
    rng = np.random.default_rng(len(which))
    for blocks in ((128, 128, 128), (128, 8, 8), (64, 64, 64)):
        um = {l.name: (rng.random(l.num_units) < 0.4).astype(np.float32) for l in js.layers}
        assert jcnn.cnn_block_compute(jcfg, um, blocks) == tcnn.cnn_block_compute(tcfg, um, blocks)
    full = {l.name: np.ones(l.num_units, np.float32) for l in js.layers}
    bc = tcnn.cnn_block_compute(tcfg, full)
    assert bc["blocks"] == bc["blocks_total"]


@pytest.mark.parametrize("which", ["r20", "r50"])
def test_init_layout_and_law(which):
    """Same keys in the same order and the same shapes as the reference's
    init; the seeded port init follows its truncated-normal law."""
    jcfg, tcfg = _pair_big(which)
    jp = jax.eval_shape(lambda: jcnn.init_cnn(jax.random.PRNGKey(0), jcfg))
    tp = tcnn.init_cnn(tcfg, torch.Generator().manual_seed(0))
    assert sorted(tp) == sorted(jp)
    if which == "r20":     # eval_shape sorts its keys; the real init keeps order
        assert list(tp) == list(_base(jcfg))
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape), k
    for k, v in tp.items():
        if k.endswith("/w"):
            fan_in = int(np.prod(v.shape[:-1]))
            scale = np.sqrt((2.0 if k != "fc/w" else 1.0) / fan_in)
            assert float(v.abs().max()) <= 2.0 * scale * (1 + 1e-6), k
        elif k.endswith("bn_g"):
            assert torch.equal(v, torch.ones_like(v))
        else:
            assert torch.equal(v, torch.zeros_like(v))


def test_config_modules_name_the_reference_nets():
    from repro.configs import resnet50_tiny as jr
    from repro.configs import vgg16_cifar as jv
    from repro_torch.configs import resnet50_tiny as tr
    from repro_torch.configs import vgg16_cifar as tv

    for jm, tm in ((jr, tr), (jv, tv)):
        for name in ("CFG", "SMOKE_CFG"):
            a, b = getattr(jm, name), getattr(tm, name)
            assert (a.name, a.kind, a.num_classes, a.image_size, tuple(a.plan), a.stem,
                    tuple(a.stages), a.bottleneck) == \
                (b.name, b.kind, b.num_classes, b.image_size, tuple(b.plan), b.stem,
                 tuple(b.stages), b.bottleneck)


# ---------------------------------------------------------------------------
# forward and gradients against JAX
# ---------------------------------------------------------------------------

def _loss_t(logits):
    return torch.log_softmax(logits, -1).sum()


def _loss_j(logits):
    return jnp.sum(jax.nn.log_softmax(logits))


KEEPS = (1.0, 0.5, 0.25)


@pytest.fixture(scope="module")
def jax_refs():
    """(net, form) -> (masked params, masks, images, JAX logits, JAX grads,
    and both again from the same JAX function in float64); ``form`` "one"
    is one model on 4 images, "stack" three worker rows at retention 1.0 /
    0.5 / 0.25 (``jax.vmap``)."""
    cache = {}

    def get(net, form):
        if (net, form) in cache:
            return cache[(net, form)]
        jcfg, _ = _cfgs(net)
        image = jcfg.image_size
        rows = [0] if form == "one" else [0, 1, 2]
        pms, ums = [], []
        for b in rows:
            base = _base(jcfg, seed=b)
            um = _prefix_masks(jcfg, base, 0.5 if form == "one" else KEEPS[b])
            pms.append(_masked(jcfg, base, um))
            ums.append(um)
        xs = np.stack([_x(4, image, 10 + b) for b in rows])
        fwd = lambda p, x: jcnn.cnn_apply(p, jcfg, x)
        if form == "one":
            pm, um, x = pms[0], ums[0], xs[0]
            apply = fwd
        else:
            pm = {k: np.stack([p[k] for p in pms]) for k in pms[0]}
            um = {k: np.stack([m[k] for m in ums]) for k in ums[0]}
            x = xs
            apply = jax.vmap(fwd)
        out = []
        for dtype in (np.float32, np.float64):
            with jax.enable_x64(dtype == np.float64):
                jp = {k: jnp.asarray(v.astype(dtype)) for k, v in pm.items()}
                xj = jnp.asarray(x.astype(dtype))

                def loss(p):
                    logits = apply(p, xj)
                    return _loss_j(logits), logits

                # the logits come out of the gradient's one jitted call (an
                # eager forward took 2-4 s of op-by-op dispatch)
                gj, lj = jax.jit(jax.grad(loss, has_aux=True))(jp)
                lj = np.asarray(lj)
                assert lj.dtype == dtype
                out += [lj, {k: np.asarray(v) for k, v in gj.items()}]
        cache[(net, form)] = (pm, um, x, *out)
        return cache[(net, form)]

    return get


def _close_to_jax(out, ref32, ref64, what):
    """``out`` within TOL of the JAX function in float64 everywhere, and of
    its float32 result wherever that lies within half of TOL of the float64
    one (the rest is the reference's own float32 rounding)."""
    np.testing.assert_allclose(out, ref64, atol=TOL, rtol=TOL, err_msg=what)
    trust = np.abs(ref32 - ref64) <= (TOL + TOL * np.abs(ref64)) / 2
    np.testing.assert_allclose(out[trust], ref32[trust], atol=TOL, rtol=TOL, err_msg=what)


@pytest.mark.parametrize("form", ["one", "stack"])
@pytest.mark.parametrize("compute", ["dense", "block_skip"])
@pytest.mark.parametrize("net", list(NETS))
def test_logits_and_grads_match_jax_dense(net, compute, form, jax_refs):
    pm, um, x, lj, gj, lj64, gj64 = jax_refs(net, form)
    _, tcfg = _cfgs(net)
    kw = {} if compute == "dense" else {
        "compute": "block_skip", "unit_masks": {k: torch.as_tensor(v) for k, v in um.items()}}
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(pm).items()}
    lt = tcnn.cnn_apply(tp, tcfg, torch.as_tensor(x), **kw)
    assert lt.shape == lj.shape
    _close_to_jax(lt.detach().numpy(), lj, lj64, "logits")
    gt = torch.autograd.grad(_loss_t(lt), list(tp.values()))
    for k, g in zip(tp, gt):
        _close_to_jax(g.numpy(), gj[k], gj64[k], k)


@pytest.mark.parametrize("net", ["bottleneck", "resnet20_small"])
def test_activation_stats_match_jax(net):
    """``cnn_apply(stats=...)``: mean |activation| after each prunable
    conv's ReLU, the HRank signal, for one model and per worker row."""
    jcfg, tcfg = _cfgs(net)
    base = _base(jcfg)
    x = _x(4, jcfg.image_size, 5)
    sj = {}
    jcnn.cnn_apply({k: jnp.asarray(v) for k, v in base.items()}, jcfg, jnp.asarray(x), stats=sj)
    st, ss = {}, {}
    tp = params_from_numpy(base)
    tcnn.cnn_apply(tp, tcfg, torch.as_tensor(x), stats=st)
    tcnn.cnn_apply({k: torch.stack([v, v]) for k, v in tp.items()}, tcfg,
                   torch.as_tensor(np.stack([x, x])), stats=ss)
    assert sorted(st) == sorted(sj) == sorted(jcnn.prunable_layer_names(jcfg))
    for k in sj:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=1e-5, atol=1e-6, err_msg=k)
        assert tuple(ss[k].shape) == (2,) + tuple(st[k].shape)
        np.testing.assert_allclose(ss[k][1].numpy(), st[k].numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# whole simulations
# ---------------------------------------------------------------------------

BOTTLENECK = (("t", 8, [(1, 8), (1, 16)]), dict(num_classes=10, image_size=8))

SIM_CASES = {
    "adaptcl_index": dict(method="adaptcl", importance="index"),
    "adaptcl_cig": dict(method="adaptcl", importance="cig_bnscalor"),
}


def _sim_pair(seed=3, **over):
    args, ckw = BOTTLENECK
    kw = dict(rounds=4, prune_interval=2, num_workers=4, batch_size=8, local_epochs=1.0,
              eval_every=1, seed=seed)
    kw.update(over)
    jcfg, tcfg = jcnn.resnet_config(*args, **ckw), tcnn.resnet_config(*args, **ckw)
    task = dict(num_classes=10, image_size=ckw["image_size"], train_size=96, test_size=64, seed=seed)
    return kw, jcfg, tcfg, task, _base(jcfg, seed)


@pytest.fixture(scope="module")
def sim_runs():
    """case -> (JAX masked dense result, port masked block_skip result)."""
    cache = {}

    def get(case):
        if case not in cache:
            kw, jcfg, tcfg, task, base = _sim_pair(**SIM_CASES[case])
            rj = j_run(JSimConfig(engine="masked", compute="dense", cnn=jcfg,
                                  task=JTask(**task), **kw))
            rt = t_run(TSimConfig(engine="masked", compute="block_skip", cnn=tcfg,
                                  task=TTask(**task), device="cpu", **kw), base_params=base)
            cache[case] = (rj, rt)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_resnet_prune_events_and_clock_identical(case, sim_runs):
    rj, rt = sim_runs(case)
    assert rt.prune_events == rj.prune_events and rt.prune_events
    assert min(rt.retentions) < 1.0
    assert rt.update_times == rj.update_times
    assert abs(rt.total_time - rj.total_time) <= 1e-9
    assert rt.retentions == rj.retentions
    assert rt.comm_bytes == rj.comm_bytes
    assert [t for t, _ in rt.acc_time] == [t for t, _ in rj.acc_time]


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_resnet_accuracy_and_params_within_contract(case, sim_runs):
    rj, rt = sim_runs(case)
    assert abs(rt.final_acc - rj.final_acc) <= 1e-3
    assert sorted(rt.global_params) == sorted(rj.global_params)
    for k in rj.global_params:
        np.testing.assert_allclose(rt.global_params[k], rj.global_params[k], atol=1e-4, err_msg=k)
    assert rt.param_reduction == pytest.approx(rj.param_reduction, abs=1e-12)
    assert rt.flops_reduction == pytest.approx(rj.flops_reduction, abs=1e-12)


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_resnet_counters_match(case, sim_runs):
    rj, rt = sim_runs(case)
    assert rt.recompiles == rj.recompiles
    assert rt.host_dispatches == rj.host_dispatches
    assert rt.batched_calls == rj.batched_calls
    assert rt.bucket_sizes == rj.bucket_sizes
    assert rt.host_roundtrips == rj.host_roundtrips == 0
    assert rt.flops_ideal == rj.flops_ideal


def test_resnet_block_ledger_equals_jax_block_skip_exactly():
    """Against the reference's own block_skip (Pallas interpret mode), at
    prefix retention ~0.25: the ledger matches to the last FLOP."""
    kw, jcfg, tcfg, task, base = _sim_pair(
        rounds=2, prune_interval=1, num_workers=2, eval_every=2, method="adaptcl",
        importance="index", fixed_pruned_rates=[[0.74, 0.74], [0.0, 0.0]],
        compute_blocks=(128, 8, 8),
    )
    task["train_size"] = 32
    rj = j_run(JSimConfig(engine="masked", compute="block_skip", cnn=jcfg, task=JTask(**task), **kw))
    rt = t_run(TSimConfig(engine="masked", compute="block_skip", cnn=tcfg, task=TTask(**task),
                          device="cpu", **kw), base_params=base)
    assert rt.prune_events == rj.prune_events and rt.prune_events
    assert rt.flops_executed == rj.flops_executed
    assert rt.blocks_executed == rj.blocks_executed
    assert rt.flops_ideal == rj.flops_ideal
    assert rt.flops_per_image_final == rj.flops_per_image_final
    assert rt.blocks_per_image_final == rj.blocks_per_image_final
    assert 0 < rt.blocks_executed
    assert abs(rt.final_acc - rj.final_acc) <= 1e-3
    for k in rj.global_params:
        np.testing.assert_allclose(rt.global_params[k], rj.global_params[k], atol=1e-4, err_msg=k)
