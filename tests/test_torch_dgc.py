"""DGC delta compression and cross-round resident momentum: the port
against the JAX package.

* ``_dgc_compress`` and ``_dgc_compress_stacked`` (host numpy in both
  packages) on seeded inputs with massive threshold ties, masks, fully masked
  rows, row gating and shape-changed residuals: bit-identical outputs and
  payload factors.
* The resident pieces: ``update_shard``, ``init_momentum``,
  ``zero_momentum_rows``, and momentum exactly zero on pruned coordinates
  after a carried phase.
* Whole runs under sampling, dropout, churn and crash/recovery with
  ``dgc_sparsity=0.9`` on each port engine against the JAX engine of the same
  name, and ``resident_momentum`` (alone and with DGC) on the port's masked
  engine (``block_skip``) against JAX masked: ROADMAP's contract plus
  identical ``scenario_rounds`` and ledger, params within 1e-4.  A run with
  the momentum reset on churn and recovery taken out misses the reference,
  so those cases see the reset.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import faults as jf
from repro.core import fleet as jfleet
from repro.core import scenario as jsc
from repro.core import simulation as jsim
from repro.core import timing as jtm
from repro.core.worker import LocalTrainer as JTrainer
from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy
from repro_torch.core import faults as tf
from repro_torch.core import fleet as tfleet
from repro_torch.core import scenario as tsc
from repro_torch.core import simulation as tsim
from repro_torch.core import timing as ttm
from repro_torch.core.masks import full_index, prune_to_budget
from repro_torch.core.worker import LocalTrainer as TTrainer
from repro_torch.core.worker import make_batch_plan
from repro_torch.data import synthetic as tsyn
from repro_torch.models import cnn as tcnn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread beats a pool of them,
    which only contends with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = {"a/w": (3, 3, 2, 4), "b/w": (8,), "c/w": (5, 6)}


def _quantized(rng, shape):
    """Values that collide at any threshold."""
    return rng.choice([-2.0, -1.0, 0.5, 1.0, 2.0], size=shape).astype(np.float32)


def _assert_tree_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.5, 0.9, 0.999])
@pytest.mark.parametrize("ties", [False, True])
def test_dgc_compress_bit_identical(sparsity, ties):
    rng = np.random.default_rng(int(sparsity * 1000) + ties)
    make = (lambda s: _quantized(rng, s)) if ties else (
        lambda s: rng.normal(size=s).astype(np.float32))
    delta = {k: make(s) for k, s in SHAPES.items()}
    # b/w's residual has a stale shape (a reconfiguration): dense restart
    residual = {"a/w": make(SHAPES["a/w"]) * np.float32(0.1), "b/w": make((16,))}
    ja = jsim._dgc_compress(delta, residual, sparsity)
    ta = tsim._dgc_compress(delta, residual, sparsity)
    _assert_tree_equal(ja[0], ta[0])
    _assert_tree_equal(ja[1], ta[1])
    assert ja[2] == ta[2]


@pytest.mark.parametrize("sparsity", [0.3, 0.7, 0.9, 0.95])
def test_dgc_compress_stacked_bit_identical(sparsity):
    rng = np.random.default_rng(10)
    W = 4
    delta = {"a/w": _quantized(rng, (W, 3, 3, 2, 4)),
             "b/w": rng.normal(size=(W, 8)).astype(np.float32),
             "c/w": _quantized(rng, (W, 5, 6))}
    residual = {k: (rng.normal(size=v.shape) * 0.1).astype(np.float32) for k, v in delta.items()}
    masks = {k: (rng.random(v.shape) < 0.7).astype(np.float32) for k, v in delta.items()}
    masks["b/w"][2] = 0.0                       # a fully masked row
    rows = np.array([True, True, False, True])
    for kw in (dict(), dict(masks=masks), dict(rows=rows), dict(masks=masks, rows=rows)):
        j = jsim._dgc_compress_stacked(delta, residual, sparsity, **kw)
        t = tsim._dgc_compress_stacked(delta, residual, sparsity, **kw)
        _assert_tree_equal(j[0], t[0])
        _assert_tree_equal(j[1], t[1])
        assert j[2].tobytes() == t[2].tobytes()
    # the fully masked row commits nothing; a gated row keeps its residual
    c, r, f = tsim._dgc_compress_stacked(delta, residual, sparsity, masks=masks, rows=rows)
    assert not c["b/w"][2].any() and not c["a/w"][2].any()
    np.testing.assert_array_equal(r["a/w"][2], residual["a/w"][2])
    assert f[2] == 1.0 and (f[rows] < 1.25).all()


# ---------------------------------------------------------------------------
# resident pieces
# ---------------------------------------------------------------------------

def _fleet_pair():
    jcfg = jcnn.vgg_config("t", [8, "M", 16], num_classes=4, image_size=8)
    tcfg = tcnn.vgg_config("t", [8, "M", 16], num_classes=4, image_size=8)
    params = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(0), jcfg).items()}
    space, unit_map = jcnn.build_unit_space(jcfg, params)
    shapes = {k: v.shape for k, v in params.items()}
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(32, 8, 8, 3)).astype(np.float32) for _ in range(4)]
    ys = [rng.integers(0, 4, 32).astype(np.int32) for _ in range(4)]
    jf_ = jfleet.FleetEngine(JTrainer(jcfg, lr=0.05), unit_map, shapes, engine="masked")
    tf_ = tfleet.FleetEngine(TTrainer(tcfg, lr=0.05, device="cpu"), unit_map, shapes, "cpu",
                             engine="masked")
    js = jf_.init_state(params, xs, ys)
    ts = tf_.init_state(params_from_numpy(params), xs, ys)
    return jf_, js, tf_, ts, space, rng


def test_update_shard_and_momentum_rows_match_jax():
    jf_, js, tf_, ts, _, rng = _fleet_pair()
    x = rng.normal(size=(32, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 4, 32).astype(np.int32)
    jf_.update_shard(js, 2, x, y)
    tf_.update_shard(ts, 2, x, y)
    np.testing.assert_array_equal(ts.xs.numpy(), np.asarray(js.xs))
    np.testing.assert_array_equal(ts.ys.numpy(), np.asarray(js.ys))
    with pytest.raises(ValueError, match="exceeds resident pad"):
        tf_.update_shard(ts, 0, np.zeros((33, 8, 8, 3), np.float32), np.zeros(33, np.int32))
    assert ts.momentum is None
    tf_.zero_momentum_rows(ts, [1])             # nothing to reset yet
    tf_.init_momentum(ts)
    for v in ts.momentum.values():
        v += 1.0
    tf_.zero_momentum_rows(ts, [1, 3])
    for v in ts.momentum.values():
        assert not v[1].any() and not v[3].any() and (v[0] == 1.0).all() and (v[2] == 1.0).all()


@pytest.mark.parametrize("rows", [[0, 1, 2, 3], [2, 0, 3]])
def test_carried_momentum_matches_jax_and_stays_zero_where_pruned(rows):
    """Two carried phases (full stack, or a 3-row bucket padded to 4) on
    pruned masks: params and momentum within 1e-5 of the reference's, and
    momentum exactly zero on every pruned coordinate."""
    jf_, js, tf_, ts, space, rng = _fleet_pair()
    scores = {l.name: rng.normal(size=l.num_units) for l in space.layers}
    indices = [prune_to_budget(full_index(space), scores, r, space) for r in (0.0, 0.3, 0.5, 0.2)]
    jf_.init_momentum(js)
    tf_.init_momentum(ts)
    for phase in range(2):
        if phase == 1:
            jf_.refresh_masks(js, indices)
            tf_.refresh_masks(ts, indices)
        plans = [make_batch_plan(32, 8, 0.5, rng) if w in rows else None for w in range(4)]
        jf_.train_rounds(js, plans, 1e-3, carry_momentum=True)
        tf_.train_rounds(ts, plans, 1e-3, carry_momentum=True)
    for k in js.params:
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]), atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(ts.momentum[k].numpy(), np.asarray(js.momentum[k]),
                                   atol=1e-5, err_msg=k)
        assert not ts.momentum[k][ts.masks[k] == 0].any(), k
    assert any((ts.masks[k] == 0).any() for k in ts.masks)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

FLAKY = dict(participation=0.8, dropout=0.2, churn=0.15, seed=6,
             faults=dict(crash=dict(rate=0.2, outage_rounds=1, recovery_rounds=1)))
RUN_CASES = {
    "dgc_sequential": ("sequential", dict(dgc_sparsity=0.9), FLAKY),
    "dgc_bucketed": ("bucketed", dict(dgc_sparsity=0.9), FLAKY),
    "dgc_masked": ("masked", dict(dgc_sparsity=0.9), FLAKY),
    "momentum_masked": ("masked", dict(resident_momentum=True), FLAKY),
    "momentum_full_fleet": ("masked", dict(resident_momentum=True), None),
    "dgc_momentum_masked": ("masked", dict(dgc_sparsity=0.9, resident_momentum=True), FLAKY),
}
LEDGER_FIELDS = ("drift_events", "rounds_degraded", "rounds_skipped", "workers_recovered",
                 "retry_total", "byz_commits", "lost_commits", "dup_commits", "corrupt_commits")


def _scenario(f, s, spec):
    if spec is None:
        return None
    spec = dict(spec)
    faults = spec.pop("faults", None)
    fc = None if faults is None else f.FaultConfig(crash=f.CrashConfig(**faults["crash"]))
    return s.ScenarioConfig(faults=fc, **spec)


def _run_kw(engine, over, seed):
    kw = dict(method="adaptcl", importance="index", rounds=6, prune_interval=2, num_workers=5,
              batch_size=8, eval_every=1, seed=seed, engine=engine, **over)
    task = dict(num_classes=10, image_size=8, train_size=100, test_size=64, seed=seed)
    return kw, task


def _run_jax(engine, over, spec, seed=3):
    kw, task = _run_kw(engine, over, seed)
    return jsim.run_simulation(jsim.SimConfig(
        cnn=jcnn.vgg_config("t", [16, "M", 32], num_classes=10, image_size=8),
        task=jsyn.SyntheticImageTask(**task), scenario=_scenario(jf, jsc, spec),
        het=jtm.HeterogeneityConfig(num_workers=5), **kw))


def _run_port(engine, over, spec, seed=3):
    kw, task = _run_kw(engine, over, seed)
    jcfg = jcnn.vgg_config("t", [16, "M", 32], num_classes=10, image_size=8)
    base = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg).items()}
    return tsim.run_simulation(tsim.SimConfig(
        cnn=tcnn.vgg_config("t", [16, "M", 32], num_classes=10, image_size=8),
        task=tsyn.SyntheticImageTask(**task), scenario=_scenario(tf, tsc, spec),
        het=ttm.HeterogeneityConfig(num_workers=5), device="cpu",
        compute="block_skip" if engine == "masked" else "dense", **kw), base_params=base)


def _run_pair(engine, over, spec, seed=3):
    return _run_jax(engine, over, spec, seed), _run_port(engine, over, spec, seed)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run_pair(*RUN_CASES[case])
        return cache[case]

    return get


def _param_diff(a, b):
    return max(float(np.abs(a.global_params[k] - b.global_params[k]).max()) for k in a.global_params)


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_matches_jax_engine_within_contract(case, runs):
    rj, rt = runs(case)
    assert rt.prune_events == rj.prune_events and rt.prune_events
    assert rt.scenario_rounds == rj.scenario_rounds
    assert {f: getattr(rt, f) for f in LEDGER_FIELDS} == {f: getattr(rj, f) for f in LEDGER_FIELDS}
    np.testing.assert_allclose(np.array(rt.update_times), np.array(rj.update_times),
                               rtol=0, atol=0, equal_nan=True)
    assert abs(rt.total_time - rj.total_time) <= 1e-9
    assert rt.comm_bytes == rj.comm_bytes
    assert abs(rt.final_acc - rj.final_acc) <= 1e-3
    assert _param_diff(rt, rj) <= 1e-4
    assert rt.recompiles == rj.recompiles and rt.host_dispatches == rj.host_dispatches
    assert rt.host_roundtrips == rj.host_roundtrips and rt.bucket_sizes == rj.bucket_sizes
    if RUN_CASES[case][2] is not None:
        rows = np.array(rt.scenario_rounds)
        assert rows[:, 3].sum() > 0 and rt.workers_recovered > 0, "churn and recovery must fire"


def test_dgc_shrinks_the_payload(runs):
    """DGC at 0.9 sends ~1.25 x 10 % of each submitted sub-model: the
    channel time and bytes fall below the dense run's."""
    for case in ("dgc_sequential", "dgc_masked"):
        engine, _, spec = RUN_CASES[case]
        dense = runs("momentum_masked")[1] if engine == "masked" else _run_port(engine, {}, spec)
        _, sparse = runs(case)
        assert sparse.comm_bytes < 0.5 * dense.comm_bytes


def test_run_without_the_momentum_reset_misses_the_reference(runs, monkeypatch):
    """Take the churn and crash-recovery momentum reset out of the port: the
    run no longer matches the reference, so the parity case above sees it."""
    rj, _ = runs("momentum_masked")
    monkeypatch.setattr(tfleet.FleetEngine, "zero_momentum_rows", lambda self, state, rows: None)
    broken = _run_port(*RUN_CASES["momentum_masked"])   # against the module's oracle
    assert _param_diff(broken, rj) > 1e-4
