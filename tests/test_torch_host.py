"""The port's host-side modules against the JAX package's, on shared seeds.

Data, bandwidths, Alg. 2, budget pruning, importance criteria, the block
ledger, group lasso, momentum, batch plans and stacked aggregation must equal
the reference (exactly where the reference computes on the host in numpy,
within f32 tolerance where it computes in JAX).  Also the port's guards: it
imports neither ``jax`` nor ``repro``, ``device="cuda"`` never falls back to
the CPU, and every configuration outside this slice is refused by name.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import fleet as jfleet
from repro.core import importance as jimp
from repro.core import masks as jmasks
from repro.core import pruned_rate as jpr
from repro.core import timing as jtiming
from repro.core import worker as jworker
from repro.data import synthetic as jsyn
from repro.kernels import pruned_matmul as jpm
from repro.models import cnn as jcnn
from repro.optim import group_lasso as jgl
from repro.optim import optimizers as jopt
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core import fleet as tfleet
from repro_torch.core import importance as timp
from repro_torch.core import masks as tmasks
from repro_torch.core import pruned_rate as tpr
from repro_torch.core import timing as ttiming
from repro_torch.core import worker as tworker
from repro_torch.core.simulation import SimConfig, run_simulation
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import pruned_matmul as tpm
from repro_torch.optim import group_lasso as tgl
from repro_torch.optim import optimizers as topt

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# data, timing, Alg. 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("image,seed", [(8, 0), (32, 3)])
def test_synthetic_task_byte_identical(image, seed):
    kw = dict(num_classes=10, image_size=image, train_size=64, test_size=32, seed=seed)
    a, b = jsyn.SyntheticImageTask(**kw), tsyn.SyntheticImageTask(**kw)
    for f in ("x_train", "y_train", "x_test", "y_test", "prototypes"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("W,s,seed", [(10, 0.0, 0), (10, 80.0, 1), (7, 50.0, 2)])
def test_partition_noniid_identical(W, s, seed):
    y = np.random.default_rng(seed).integers(0, 10, 1280).astype(np.int32)
    for a, b in zip(jsyn.partition_noniid(y, W, s, seed), tsyn.partition_noniid(y, W, s, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("W,sigma,bmax", [(10, 2.0, None), (1, 2.0, None), (5, 3.5, 1e6)])
def test_bandwidths_and_heterogeneity_equal(W, sigma, bmax):
    kw = dict(num_workers=W, sigma=sigma, bandwidth_max=bmax)
    a = jtiming.make_bandwidths(jtiming.HeterogeneityConfig(**kw), 123456.0, 1.0)
    b = ttiming.make_bandwidths(ttiming.HeterogeneityConfig(**kw), 123456.0, 1.0)
    assert a == b
    phis = np.random.default_rng(W).random(W) + 0.5
    assert jtiming.heterogeneity_from_times(phis) == ttiming.heterogeneity_from_times(phis)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_learn_pruned_rates_bit_identical(seed):
    rng = np.random.default_rng(seed)
    W = 6
    hj = [jpr.WorkerHistory() for _ in range(W)]
    ht = [tpr.WorkerHistory() for _ in range(W)]
    gammas = np.ones(W)
    for step in range(4):
        phis = (1.0 + rng.random(W)) * gammas
        for w in range(W):
            hj[w].record(gammas[w], phis[w])
            ht[w].record(gammas[w], phis[w])
        cfg_j, cfg_t = jpr.PrunedRateConfig(), tpr.PrunedRateConfig()
        rj = jpr.learn_pruned_rates(hj, gammas, phis, cfg_j)
        rt = tpr.learn_pruned_rates(ht, gammas, phis, cfg_t)
        assert rj == rt
        gammas = gammas * (1.0 - np.asarray(rj))


# ---------------------------------------------------------------------------
# masks, importance, block ledger
# ---------------------------------------------------------------------------

def _spaces():
    layers = [("a", 16, 30, 2), ("b", 24, 11, 2), ("c", 9, 50, 1)]
    js = jmasks.UnitSpace(layers=tuple(jmasks.UnitLayer(*l) for l in layers), fixed_params=500)
    ts = tmasks.UnitSpace(layers=tuple(tmasks.UnitLayer(*l) for l in layers), fixed_params=500)
    return js, ts


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.37, 0.8])
@pytest.mark.parametrize("ties", [False, True])
def test_prune_to_budget_identical(rate, ties):
    js, ts = _spaces()
    rng = np.random.default_rng(int(rate * 100) + ties)
    scores = {l.name: rng.random(l.num_units) for l in js.layers}
    if ties:   # quantized scores: the (score, layer, unit) tie-break decides
        scores = {k: np.round(v * 3) / 3 for k, v in scores.items()}
    idx = {l.name: np.sort(rng.choice(l.num_units, l.num_units - 3, replace=False))
           for l in js.layers}
    a = jmasks.prune_to_budget(idx, scores, rate, js)
    b = tmasks.prune_to_budget(idx, scores, rate, ts)
    assert {k: v.tolist() for k, v in a.items()} == {k: v.tolist() for k, v in b.items()}
    assert jmasks.retention(a, js) == tmasks.retention(b, ts)
    assert jmasks.payload_bytes(a, js) == tmasks.payload_bytes(b, ts)
    assert jmasks.similarity(a, idx) == tmasks.similarity(b, idx)


@pytest.mark.parametrize("method", ["index", "no_adjacent", "no_identical", "no_constant"])
def test_seed_derived_importance_identical(method):
    counts = {"conv0": 16, "conv1": 32, "conv2": 7}
    for worker, rnd, seed in [(0, 1, 0), (3, 2, 5)]:
        a = jimp.METHODS[method](jimp.ImportanceContext(unit_counts=counts, worker=worker,
                                                        round=rnd, seed=seed))
        b = timp.METHODS[method](timp.ImportanceContext(unit_counts=counts, worker=worker,
                                                        round=rnd, seed=seed))
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_cig_importance_identical():
    scales = {"conv0": np.abs(np.random.default_rng(0).normal(size=16))}
    a = jimp.METHODS["cig_bnscalor"](jimp.ImportanceContext(unit_counts={"conv0": 16}, scales=scales))
    b = timp.METHODS["cig_bnscalor"](timp.ImportanceContext(unit_counts={"conv0": 16}, scales=scales))
    np.testing.assert_array_equal(a["conv0"], b["conv0"])


@pytest.mark.parametrize("block", [8, 64, 128])
def test_block_accounting_identical(block):
    rng = np.random.default_rng(block)
    for n in (27, 128, 300, 4608):
        m = (rng.random(n) < 0.3).astype(np.float32)
        assert jpm.block_keep_count(m, block) == tpm.block_keep_count(m, block)
        o = (rng.random(64) < 0.5).astype(np.float32)
        for M in (1, 32, 32768):
            kw = dict(block_m=128, block_n=block, block_k=block)
            assert jpm.matmul_executed_blocks(M, m, o, **kw) == tpm.matmul_executed_blocks(M, m, o, **kw)
            assert jpm.matmul_executed_flops(M, m, o, **kw) == tpm.matmul_executed_flops(M, m, o, **kw)


# ---------------------------------------------------------------------------
# optimizer, regularizer, worker helpers, aggregation, fleet
# ---------------------------------------------------------------------------

def _small_model():
    cfg = jcnn.vgg_config("t", [8, "M", 12], num_classes=10, image_size=8)
    params = {k: np.array(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(0), cfg).items()}
    params["conv0/bn_g"] = np.random.default_rng(1).normal(size=8).astype(np.float32)
    params["conv1/w"][..., :3] = 0.0            # all-zero groups hit the 1e-12 floor
    params["conv1/bn_g"][:3] = 0.0
    params["conv1/bn_b"][:3] = 0.0
    space, unit_map = jcnn.build_unit_space(cfg, params)
    return cfg, params, space, unit_map


def test_group_lasso_value_and_grads_match_jax():
    cfg, params, space, unit_map = _small_model()
    um = {k: tuple(v) for k, v in unit_map.items()}
    size = {"conv0": 2.5, "conv1": 7.0}
    vj, gj = jax.jit(jax.value_and_grad(
        lambda p: jgl.group_lasso_penalty(p, um, 1e-2, size_sqrt=size)))(
        {k: jnp.asarray(params[k]) for k in unit_map})
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(params).items() if k in unit_map}
    vt = tgl.group_lasso_penalty(tp, unit_map, 1e-2, size_sqrt=size)
    gt = torch.autograd.grad(vt, list(tp.values()))
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-6)
    for k, g in zip(tp, gt):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[k]), atol=1e-6, rtol=1e-5, err_msg=k)
    assert float(gt[list(tp).index("conv1/bn_g")][:3].abs().max()) == 0.0
    # batched rows == per-row values (default factors: shape-derived sqrt|g|)
    stack = {k: torch.stack([v.detach(), 2 * v.detach()]) for k, v in tp.items()}
    rows = tgl.group_lasso_penalty(stack, unit_map, 1e-2, batch_dims=1)
    for b in range(2):
        one = tgl.group_lasso_penalty({k: v[b] for k, v in stack.items()}, unit_map, 1e-2)
        np.testing.assert_allclose(float(rows[b]), float(one), rtol=1e-6)
    assert tgl.group_size_sqrt(tp, unit_map) == jgl.group_size_sqrt(params, unit_map)


def test_momentum_matches_jax_optimizer():
    rng = np.random.default_rng(0)
    p = {"a": rng.normal(size=(3, 4)).astype(np.float32)}
    oj, ot = jopt.momentum(0.05, 0.9), topt.momentum(0.05, 0.9)
    pj, sj = {"a": jnp.asarray(p["a"])}, oj.init({"a": jnp.asarray(p["a"])})
    pt = params_from_numpy(p)
    st = ot.init(pt)
    for _ in range(4):
        g = {"a": rng.normal(size=(3, 4)).astype(np.float32)}
        uj, sj = oj.update({"a": jnp.asarray(g["a"])}, sj, pj)
        pj = jopt.apply_updates(pj, uj)
        ut, st = ot.update(params_from_numpy(g), st)
        pt = topt.apply_updates(pt, ut)
    np.testing.assert_allclose(pt["a"].numpy(), np.asarray(pj["a"]), atol=1e-7)


@pytest.mark.parametrize("n,batch,epochs", [(128, 32, 1.0), (50, 8, 0.5), (37, 16, 2.3), (10, 4, 0.0)])
def test_batch_plans_identical(n, batch, epochs):
    a = jworker.make_batch_plan(n, batch, epochs, np.random.default_rng(7))
    b = tworker.make_batch_plan(n, batch, epochs, np.random.default_rng(7))
    np.testing.assert_array_equal(a, b)
    assert jworker.plan_steps(n, batch, epochs) == tworker.plan_steps(n, batch, epochs) == a.shape[0]
    sa = jworker.stack_batch_plans([a, None, a[:1]], num_rows=4, num_steps=5)
    sb = tworker.stack_batch_plans([b, None, b[:1]], num_rows=4, num_steps=5)
    for x, y in zip(sa, sb):
        np.testing.assert_array_equal(x, y)


def test_stacked_aggregation_and_extraction_match_jax():
    cfg, params, space, unit_map = _small_model()
    rng = np.random.default_rng(3)
    W = 4
    shapes = {k: v.shape for k, v in params.items()}
    idx = [{l.name: np.sort(rng.choice(l.num_units, l.num_units - w, replace=False))
            for l in space.layers} for w in range(W)]
    masks = {k: np.stack([jagg.coordinate_mask(k, idx[w], unit_map, shapes) for w in range(W)])
             for k in params}
    stacks = {k: (rng.normal(size=(W,) + v.shape) * masks[k]).astype(np.float32)
              for k, v in params.items()}
    sub = np.array([1, 0, 1, 1], bool)
    a = jagg.aggregate_by_worker_stacked(stacks, sub / sub.sum())
    b = tagg.aggregate_by_worker_stacked(params_from_numpy(stacks), sub / sub.sum())
    c = jagg.aggregate_by_unit_stacked(stacks, masks, sub)
    d = tagg.aggregate_by_unit_stacked(params_from_numpy(stacks), params_from_numpy(masks), sub)
    for k in params:
        assert b[k].dtype == torch.float64
        np.testing.assert_allclose(b[k].numpy(), a[k], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(d[k].numpy(), c[k], rtol=1e-12, atol=1e-12)
    assert tagg.subparam_shapes(idx[2], unit_map, shapes) == jagg.subparam_shapes(idx[2], unit_map, shapes)
    ej = jagg.extract_subparams(params, idx[2], unit_map)
    et = params_to_numpy(tagg.extract_subparams(params_from_numpy(params), idx[2], unit_map))
    for k in ej:
        np.testing.assert_array_equal(et[k], ej[k])


def test_fleet_rows_and_buckets():
    for n in range(1, 12):
        assert tfleet.bucket_rows(n, 10) == jfleet.bucket_rows(n, 10)
    stacks = {"a": torch.arange(20.0).reshape(5, 4)}
    sub = tfleet.gather_stack_rows(stacks, [3, 1, 3], 5)
    assert sub["a"][:, 0].tolist() == [12.0, 4.0, 12.0]
    back = tfleet.scatter_stack_rows(stacks, [3, 1], {"a": sub["a"] * -1}, 5)
    assert back["a"][3, 0] == -12.0 and back["a"][1, 0] == -4.0 and back["a"][0, 0] == 0.0
    with pytest.raises(ValueError, match="outside"):
        tfleet.gather_stack_rows(stacks, [5], 5)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def _port_files():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
            + sorted((ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    assert ROOT / "src" / "repro_torch" / "core" / "fused.py" in files
    assert ROOT / "src" / "repro_torch" / "bench" / "run.py" in files
    assert ROOT / "examples" / "torch_adaptcl_sim.py" in files
    assert ROOT / "examples" / "torch_heterogeneity_sweep.py" in files
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "benchmarks", "flax", "optax"), (
                    path, name)


def test_cuda_device_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' legitimately runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_simulation(SimConfig(rounds=1, num_workers=2))
    assert SimConfig().device == "cuda"


class _Mesh:
    """A mesh's shape alone: the guards fire before any collective."""

    def __init__(self, **shape):
        self.shape = shape


def _byzantine_scenario():
    from repro_torch.core.faults import ByzantineConfig, FaultConfig
    from repro_torch.core.scenario import ScenarioConfig

    return ScenarioConfig(faults=FaultConfig(byzantine=ByzantineConfig(workers=(0,))))


def _defense():
    from repro_torch.core.aggregation import QuarantineConfig, RobustAggConfig

    return RobustAggConfig(clip=5.0, trim=0.2, quarantine=QuarantineConfig())


# explicit ids keep each case's name from before scenarios, DGC, the fused
# engine and the robust layer were ported; the byzantine family and the
# robust layer are refused only where the reference refuses them (by_unit
# aggregation), resident_momentum only off the resident engines (the default
# engine is sequential), and the mesh (ported with A10) where the reference
# refuses it: a mesh without the fleet axis, and a mesh off the fused engine
@pytest.mark.parametrize("field,value,extra,match,why", [
    pytest.param("mesh", _Mesh(data=2), dict(engine="fused"), r"SimConfig\.mesh axes",
                 "no fleet axis 'fleet'", id="engine-fused"),
    pytest.param("scenario", _byzantine_scenario(), dict(aggregation="by_unit"),
                 r"FaultConfig\.byzantine perturbs", "aggregation='by_worker'",
                 id="scenario-value1"),
    pytest.param("robust", _defense(), dict(aggregation="by_unit"), r"SimConfig\.robust",
                 "aggregation='by_worker'", id="robust-value4"),
    pytest.param("mesh", _Mesh(fleet=2), {}, r"SimConfig\.mesh", "requires the fused SYNC engine",
                 id="mesh-value5"),
    pytest.param("resident_momentum", True, {}, r"SimConfig\.resident_momentum",
                 "engine='masked' or 'fused'", id="resident_momentum-True"),
])
def test_out_of_slice_fields_are_refused_by_name(field, value, extra, match, why):
    sim = SimConfig(rounds=1, num_workers=2, device="cpu", **{field: value}, **extra)
    with pytest.raises(ValueError, match=match) as err:
        run_simulation(sim)
    assert why in str(err.value)


@pytest.mark.parametrize("method", ["fedasync_s", "ssp_s", "dcasgd_s"])
def test_async_on_the_fused_engine_is_refused_by_name(method):
    """The async methods run on every engine, ``fused`` included, with the
    robust layer's clip and quarantine; the trimmed mean is refused by name
    for them, on the fused engine too, as in the reference."""
    from repro_torch.core.aggregation import RobustAggConfig

    sim = SimConfig(method=method, engine="fused", robust=RobustAggConfig(trim=0.2), rounds=1,
                    num_workers=2, device="cpu")
    with pytest.raises(ValueError, match=r"RobustAggConfig\.trim=0\.2") as err:
        run_simulation(sim)
    assert "clip + quarantine only" in str(err.value)


@pytest.mark.parametrize("method", ["fedasync_s", "ssp_s", "dcasgd_s"])
def test_regrow_on_an_async_method_is_refused(method):
    """The reference's rule: async workers never prune, nothing regrows."""
    from repro_torch.core.simulation import RegrowConfig

    sim = SimConfig(method=method, regrow=RegrowConfig(), rounds=1, num_workers=2, device="cpu")
    with pytest.raises(ValueError, match=r"SimConfig\.regrow .* synchronous methods only"):
        run_simulation(sim)


@pytest.mark.parametrize("engine", ["sequential", "bucketed"])
def test_block_skip_needs_the_masked_engine(engine):
    """The reference's own rule: block-keep flags come from the mask stacks,
    so compute='block_skip' runs only on engine='masked'."""
    sim = SimConfig(rounds=1, num_workers=2, device="cpu", engine=engine, compute="block_skip")
    with pytest.raises(ValueError, match=r"SimConfig\.compute='block_skip' needs engine='masked'"):
        run_simulation(sim)
    assert SimConfig().engine == "sequential"
