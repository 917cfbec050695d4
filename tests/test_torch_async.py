"""The port's asynchronous schedulers against the JAX package's.

``fedasync_s``, ``ssp_s`` and ``dcasgd_s``:

* the merge goldens of ``tests/test_async_resident.py`` with the same
  literal values, on the port's ``AsyncServer``; and both packages'
  ``AsyncServer`` on one scripted commit sequence, bit-identical and
  float32 throughout;
* the event planner: every ``AsyncEventPlan`` array of the port's
  ``_plan_async_events`` equal (``np.array_equal``) to the JAX planner's, for
  each method, serial and windowed, and under sampling with dropout and
  crash;
* whole runs of each method on each engine (``sequential``, ``bucketed``,
  ``masked`` dense and block_skip, the kernel's plain version on the CPU)
  against the JAX engine of the same name, from the JAX init: total time
  within 1e-9, the eval clocks identical, final_acc within 1e-3, global
  params within 1e-4, scenario rounds, fault ledger, bucket sizes and the
  host-round-trip count identical (0 on ``masked``, one ``async_merge`` a
  merged commit on the per-worker engines);
* the empty-plan commit (``local_epochs=0``), the sampled cohort and its
  bucket bound, fewer fleet calls when windowed, crash recovery, and the
  sync-only scenario parts refused by name.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import faults as jf
from repro.core import scenario as jsc
from repro.core import simulation as jsim
from repro.core.timing import HeterogeneityConfig as JHet
from repro.data.synthetic import SyntheticImageTask as JTask
from repro.models import cnn as jcnn
from repro_torch.core import aggregation as tagg
from repro_torch.core import faults as tf
from repro_torch.core import scenario as tsc
from repro_torch.core import simulation as tsim
from repro_torch.core.timing import HeterogeneityConfig as THet
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


METHODS = ("fedasync_s", "ssp_s", "dcasgd_s")
PLAN = [8, "M", 16]
SEED = 5
TASK = dict(num_classes=4, image_size=8, train_size=160, test_size=128, seed=SEED)
LEDGER_FIELDS = ("drift_events", "rounds_degraded", "rounds_skipped", "workers_recovered",
                 "retry_total", "byz_commits", "lost_commits", "dup_commits", "corrupt_commits",
                 "quarantined_commits")
PLAN_FIELDS = [f.name for f in dataclasses.fields(jsc.AsyncEventPlan)
               if f.name not in ("plans", "fault_ledger")]
# the fleet scenario of the async runs: a 4-of-5 cohort, timed-out commits
# and crashes
FLEET = dict(scen=dict(participation=0.8, dropout=0.2, seed=2),
             crash=dict(rate=0.3, outage_rounds=2))


def scenario(pkg, scen=None, crash=None, **faults):
    """The same ScenarioConfig in both packages (``pkg`` "jax" | "port");
    ``faults`` maps further families to their kwargs."""
    if scen is None:
        return None
    f, s = (jf, jsc) if pkg == "jax" else (tf, tsc)
    fams = dict(faults, **({"crash": crash} if crash is not None else {}))
    names = {"crash": "CrashConfig", "drift": "DriftConfig", "outage": "OutageConfig",
             "wave": "WaveConfig"}
    fc = f.FaultConfig(**{k: getattr(f, names[k])(**v) for k, v in fams.items()}) if fams else None
    return s.ScenarioConfig(faults=fc, **scen)


def configs(method, engine, W=5, scen=None, crash=None, compute="dense", **kw):
    """(JAX SimConfig, port SimConfig) of one async run."""
    base = dict(method=method, engine=engine, rounds=4 if method == "ssp_s" else 2,
                num_workers=W, batch_size=16, eval_every=2, seed=SEED)
    base.update(kw)
    jc = jsim.SimConfig(cnn=jcnn.vgg_config("tiny_async", PLAN, num_classes=4, image_size=8),
                        het=JHet(num_workers=W, sigma=3.0), task=JTask(**TASK),
                        scenario=scenario("jax", scen, crash), **base)
    tc = tsim.SimConfig(cnn=tcnn.vgg_config("tiny_async", PLAN, num_classes=4, image_size=8),
                        het=THet(num_workers=W, sigma=3.0), task=TTask(**TASK),
                        scenario=scenario("port", scen, crash), device="cpu", compute=compute,
                        compute_blocks=(8, 8, 8), **base)
    return jc, tc


_INIT = {}


def jax_init(cfg):
    if cfg.cnn.name not in _INIT:
        _INIT[cfg.cnn.name] = {k: np.asarray(v) for k, v in
                               jcnn.init_cnn(jax.random.PRNGKey(SEED), cfg.cnn).items()}
    return _INIT[cfg.cnn.name]


def port_run(tc, jc):
    return tsim.run_simulation(tc, base_params=jax_init(jc))


@pytest.fixture(scope="module")
def cache():
    store = {}

    def get(key, fn, *args, **kw):
        if key not in store:
            store[key] = fn(*args, **kw)
        return store[key]

    return get


# ---------------------------------------------------------------------------
# merge goldens (tests/test_async_resident.py's literal values)
# ---------------------------------------------------------------------------

def test_fedasync_polynomial_weights_golden():
    expected = {0: 0.5, 1: 0.3535533905932738, 2: 0.28867513459481287,
                5: 0.2041241452319315, 10: 0.15075567228888181}
    for s, want in expected.items():
        assert tagg.fedasync_weight(0.5, s) == pytest.approx(want, abs=1e-12)
        assert tagg.fedasync_weight(0.5, s) == jagg.fedasync_weight(0.5, s)
    assert tagg.fedasync_weight(0.8, 0) == pytest.approx(0.8, abs=1e-12)


def test_fedasync_scripted_merge_golden():
    srv = tagg.AsyncServer("fedasync_s", {"w": np.array([1.0])}, 4, fedasync_a=0.5)
    g0 = {"w": np.array([1.0])}
    srv.commit(0, {"w": np.array([2.0])}, g0, 0)
    assert srv.params["w"][0] == pytest.approx(1.5, abs=1e-12)
    srv.commit(1, {"w": np.array([3.0])}, g0, 3)
    assert srv.params["w"][0] == pytest.approx(1.875, abs=1e-12)
    assert srv.version == 2


def test_ssp_scripted_merge_golden():
    srv = tagg.AsyncServer("ssp_s", {"w": np.array([1.0])}, 4)
    out = srv.commit(2, {"w": np.array([3.0])}, {"w": np.array([1.0])}, 5)
    assert out["w"][0] == pytest.approx(1.0 + (3.0 - 1.0) / 4, abs=1e-12)
    out = srv.commit(0, {"w": np.array([0.5])}, {"w": np.array([1.5])}, 0)
    assert out["w"][0] == pytest.approx(1.5 - 1.0 / 4, abs=1e-12)
    srv = tagg.AsyncServer("ssp_s", {"w": np.array([1.0])}, 200, cohort_size=2)
    out = srv.commit(7, {"w": np.array([3.0])}, {"w": np.array([1.0])}, 0)
    assert out["w"][0] == pytest.approx(2.0, abs=1e-12)


def test_dcasgd_compensation_golden():
    g0 = {"w": np.array([1.0, -2.0])}
    srv = tagg.AsyncServer("dcasgd_s", g0, 2, lr=0.1, dcasgd_lambda=2.0, dcasgd_m=0.95)
    fetched = {0: dict(srv.params), 1: dict(srv.params)}
    script = [
        (0, [0.8, -1.9], [0.8, -1.9]),
        (1, [1.1, -2.2], [0.98101915, -2.26203830]),
        (0, [0.7, -1.6], [0.82884827, -1.02296241]),
    ]
    for w, trained, want in script:
        out = srv.commit(w, {"w": np.array(trained)}, fetched[w], 0)
        np.testing.assert_allclose(out["w"], want, atol=1e-6)
        fetched[w] = dict(srv.params)
    np.testing.assert_allclose(srv.backup["w"][0], srv.params["w"], atol=1e-12)


def test_async_server_rejects_unknown_method():
    srv = tagg.AsyncServer("fedasync_s", {"w": np.array([1.0])}, 2)
    srv.method = "nope"
    with pytest.raises(ValueError):
        srv.commit(0, {"w": np.array([1.0])}, {"w": np.array([1.0])}, 0)


@pytest.mark.parametrize("method", METHODS)
def test_async_servers_bit_identical_on_one_script(method):
    """Both servers over 12 scripted float32 commits from 3 slots (a cohort
    of 2 for SSP), staleness 0-4: every global bit-identical and float32,
    DC-ASGD's backup and mean-square stacks too."""
    rng = np.random.default_rng(11)
    g0 = {"a/w": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    kw = dict(cohort_size=2, fedasync_a=0.6, lr=0.05, dcasgd_lambda=2.0, dcasgd_m=0.95)
    servers = [jagg.AsyncServer(method, g0, 3, **kw), tagg.AsyncServer(method, g0, 3, **kw)]
    fetched = [[dict(g0) for _ in range(3)] for _ in servers]
    for step in range(12):
        w = int(rng.integers(3))
        s = int(rng.integers(5))
        trained = {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
                   for k, v in fetched[0][w].items()}
        outs = [srv.commit(w, trained, f[w], s) for srv, f in zip(servers, fetched)]
        for k in g0:
            assert outs[1][k].dtype == np.float32, (step, k)
            assert outs[0][k].tobytes() == outs[1][k].tobytes(), (step, k)
        for f, out in zip(fetched, outs):
            f[w] = dict(out)
    assert servers[0].version == servers[1].version == 12
    if method == "dcasgd_s":
        for k in g0:
            assert servers[1].backup[k].dtype == servers[1].dc_m[k].dtype == np.float32
            assert servers[0].backup[k].tobytes() == servers[1].backup[k].tobytes()
            assert servers[0].dc_m[k].tobytes() == servers[1].dc_m[k].tobytes()


# ---------------------------------------------------------------------------
# the event planner
# ---------------------------------------------------------------------------

PLAN_CASES = {
    **{f"{m}-serial": dict(method=m) for m in METHODS},
    **{f"{m}-window": dict(method=m, async_window=0.4) for m in METHODS},
    **{f"{m}-fleet": dict(method=m, async_window=0.3, rounds=5, **FLEET) for m in METHODS},
    "ssp_s-threshold1": dict(method="ssp_s", ssp_threshold=1, rounds=5, W=7),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_async_event_plan_arrays_equal(case):
    kw = dict(PLAN_CASES[case])
    jc, tc = configs(kw.pop("method"), "sequential", **kw)
    jenv, tenv = jsim._Env(jc), tsim._Env(tc, base_params=jax_init(jc))
    plans = []
    for pkg, env, sim in ((jsim, jenv, jc), (tsim, tenv, tc)):
        scen = (jsc if pkg is jsim else tsc).ScenarioEngine(sim.scenario, sim.num_workers) \
            if sim.scenario is not None else None
        parts = scen.static_participants() if scen is not None else np.arange(sim.num_workers)
        plans.append((parts, pkg._plan_async_events(sim, env, scen, parts)))
    (jp, ja), (tp, ta) = plans
    assert np.array_equal(jp, tp)
    assert [f.name for f in dataclasses.fields(tsc.AsyncEventPlan)] == \
        [f.name for f in dataclasses.fields(jsc.AsyncEventPlan)]
    for f in PLAN_FIELDS:
        a, b = getattr(ja, f), getattr(ta, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert len(ja.plans) == len(ta.plans) == ta.num_events > 0
    assert all(np.array_equal(a, b) for a, b in zip(ja.plans, ta.plans))
    assert ja.fault_ledger == ta.fault_ledger
    # the streams after the plan are where the reference left them
    assert jenv.rng.bit_generator.state == tenv.rng.bit_generator.state
    if "window" in case or "fleet" in case:
        assert (np.diff(ta.batch_starts) > 1).any(), "the window must batch commits"
    if "fleet" in case:
        assert ta.dropped.any() and ta.fault_ledger["workers_recovered"] > 0
        assert len(tp) == 4
    if case.startswith("ssp_s"):
        assert (ta.refetch.sum(axis=1) > 1).any(), "SSP must block and release a worker"


# ---------------------------------------------------------------------------
# whole runs against the same-named JAX engine
# ---------------------------------------------------------------------------

ENGINES = [("sequential", "dense"), ("bucketed", "dense"), ("masked", "dense"),
           ("masked", "block_skip")]


def fleet_run(method, engine, compute, cache):
    kw = dict(async_window=0.3, **FLEET)
    jc, tc = configs(method, engine, compute=compute, **kw)
    rj = cache(("jax", method, engine), jsim.run_simulation, jc)
    rt = cache(("port", method, engine, compute), port_run, tc, jc)
    return rj, rt


@pytest.mark.parametrize("engine,compute", ENGINES)
@pytest.mark.parametrize("method", METHODS)
def test_async_run_matches_jax_engine(method, engine, compute, cache):
    rj, rt = fleet_run(method, engine, compute, cache)
    assert abs(rt.total_time - rj.total_time) <= 1e-9
    assert [t for t, _ in rt.acc_time] == [t for t, _ in rj.acc_time]
    assert abs(rt.final_acc - rj.final_acc) <= 1e-3
    for k in rj.global_params:
        np.testing.assert_allclose(rt.global_params[k], rj.global_params[k], atol=1e-4,
                                   err_msg=k)
    assert rt.scenario_rounds == rj.scenario_rounds == [(0, 4, 0, 0)]
    assert {f: getattr(rt, f) for f in LEDGER_FIELDS} == {f: getattr(rj, f) for f in LEDGER_FIELDS}
    assert rt.bucket_sizes == rj.bucket_sizes
    assert rt.host_roundtrips == rj.host_roundtrips
    assert rt.batched_calls == rj.batched_calls
    assert rt.comm_bytes == rj.comm_bytes and rt.flops_ideal == rj.flops_ideal
    assert rt.prune_events == [] and rt.retentions == [1.0] * 5
    if engine == "masked":
        assert rt.host_roundtrips == 0 and rt.bucket_sizes
    else:
        assert rt.host_roundtrips > 0 and rt.bucket_sizes == []


@pytest.mark.parametrize("engine", ["sequential", "masked"])
def test_empty_plan_commits_the_fetched_params(engine):
    """local_epochs=0: every plan is empty, nothing trains, and each commit
    merges the snapshot it fetched, as in the reference."""
    jc, tc = configs("fedasync_s", engine, rounds=1, W=2, local_epochs=0.0)
    rj, rt = jsim.run_simulation(jc), port_run(tc, jc)
    assert rt.total_time == rj.total_time and rt.train_steps == 0
    for k in rj.global_params:
        assert np.array_equal(rt.global_params[k], rj.global_params[k]), k
        np.testing.assert_allclose(rt.global_params[k], jax_init(jc)[k], atol=1e-6)
    assert rt.host_roundtrips == rj.host_roundtrips == (0 if engine == "masked" else 2)


def test_async_sampling_cohort_and_bucket_bound():
    """C=0.5 of 8 slots: only the 4 sampled participants enter the event
    loop and sub-stacks are sized to them."""
    _, tc = configs("fedasync_s", "masked", W=8, async_window=30.0,
                    scen=dict(participation=0.5, seed=2))
    r = tsim.run_simulation(tc)
    assert r.scenario_rounds == [(0, 4, 0, 0)]
    assert r.host_roundtrips == 0
    assert max(r.bucket_sizes) <= 4
    assert r.recompiles <= len(r.bucket_sizes)
    assert 0.0 <= r.final_acc <= 1.0


def test_windowed_run_makes_fewer_fleet_calls():
    _, serial = configs("fedasync_s", "masked", W=6, rounds=3)
    _, windowed = configs("fedasync_s", "masked", W=6, rounds=3, async_window=30.0)
    a, b = tsim.run_simulation(serial), tsim.run_simulation(windowed)
    assert b.batched_calls < a.batched_calls == 6 * 3
    assert a.bucket_sizes == [1] and max(b.bucket_sizes) > 1
    assert b.train_steps < a.train_steps     # a batch's rows step together


@pytest.mark.parametrize("method", METHODS)
def test_async_crash_recovery(method):
    """A crashed worker's next schedule waits out its outage: the same run
    without the crash family ends earlier."""
    kw = dict(method=method, engine="masked", rounds=4)
    _, crashed = configs(scen=dict(participation=1.0, seed=2),
                         crash=dict(rate=0.4, outage_rounds=3), **kw)
    _, plain = configs(scen=dict(participation=1.0, seed=2), **kw)
    a, b = tsim.run_simulation(crashed), tsim.run_simulation(plain)
    assert a.workers_recovered > 0 and a.retry_total == a.workers_recovered
    assert a.total_time > b.total_time
    assert b.workers_recovered == 0


SYNC_ONLY = {
    "outage": (dict(outage=dict(start=2, length=1, slot_lo=0, slot_hi=2)), "outage fault family"),
    "drift": (dict(drift=dict(worker=1, round=2, factor=2.0)), "drift fault family"),
    "wave": (dict(wave=dict(amplitude=0.3, period=4)), "wave fault family"),
    "schedule": (None, "scripted schedules"),
    "churn": (None, "reject scenario churn"),
}


@pytest.mark.parametrize("family", list(SYNC_ONLY))
@pytest.mark.parametrize("method", METHODS)
def test_sync_only_scenario_parts_are_refused_by_name(method, family):
    faults, words = SYNC_ONLY[family]
    scen_kw = dict(seed=2)
    if family == "churn":
        scen_kw["churn"] = 0.2
    if family == "schedule":
        scen_kw["schedule"] = [tsc.RoundEvents(active=np.ones(3, bool), dropped=np.zeros(3, bool),
                                               joined=np.zeros(3, bool))]
    sc = tsc.ScenarioConfig(
        faults=None if faults is None else tf.FaultConfig(
            **{k: getattr(tf, f"{k.capitalize()}Config")(**v) for k, v in faults.items()}),
        **scen_kw)
    sim = tsim.SimConfig(method=method, num_workers=3, rounds=1, device="cpu", scenario=sc)
    with pytest.raises(ValueError, match=words):
        tsim.run_simulation(sim)


@pytest.mark.parametrize("method", METHODS)
def test_resident_momentum_is_refused_for_async(method):
    sim = tsim.SimConfig(method=method, engine="masked", resident_momentum=True,
                         num_workers=2, rounds=1, device="cpu")
    with pytest.raises(ValueError, match="resident_momentum is a synchronous-round carry"):
        tsim.run_simulation(sim)
