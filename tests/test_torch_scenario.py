"""The port's scenario layer against the JAX package's.

Host pieces first, exactly: ``ScenarioEngine`` draws every ``RoundEvents``
field identically for 12 rounds under sampling, dropout, churn (with the
fresh-shard draws interleaved on the same stream), an explicit schedule and
each of the six fault families; ``draw_all`` equals the lazy draws;
``partition_dirichlet`` shards are byte-identical; ``drift_multiplier``,
``heterogeneity_closed_form``, ``ChannelModel`` and ``fault_ledger`` give the
same numbers; every config validation raises on the same inputs with the
same message.  Then whole runs under sampling + dropout + churn, and under
Dirichlet skew, on each port engine against the JAX engine of the same name
(the port's masked engine with ``compute="block_skip"``, the kernel's plain
version on the CPU, against the JAX masked engine with ``compute="dense"``),
under ROADMAP's parity contract plus identical ``scenario_rounds`` and
fault ledger, global params within 1e-4, and equal counters.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import faults as jf
from repro.core import scenario as jsc
from repro.core import timing as jtm
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import run_simulation as j_run
from repro.data import synthetic as jsyn
from repro.models import cnn as jcnn
from repro_torch.core import faults as tf
from repro_torch.core import scenario as tsc
from repro_torch.core import timing as ttm
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import run_simulation as t_run
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


W = 7
FAMILY = {"drift": "DriftConfig", "crash": "CrashConfig", "outage": "OutageConfig",
          "wave": "WaveConfig", "byzantine": "ByzantineConfig", "channel": "ChannelConfig"}
EVENT_FIELDS = [f.name for f in dataclasses.fields(jsc.RoundEvents)]
LEDGER_FIELDS = ("drift_events", "rounds_degraded", "rounds_skipped", "workers_recovered",
                 "retry_total", "byz_commits", "lost_commits", "dup_commits",
                 "corrupt_commits", "quarantined_commits")


def scenario_pair(faults=None, schedule=None, **kw):
    """The same ScenarioConfig in both packages; ``faults`` maps a family
    name to its config kwargs, ``schedule`` is a list of (active, dropped,
    joined) rows."""
    out = []
    for f, s in ((jf, jsc), (tf, tsc)):
        fc = None if faults is None else f.FaultConfig(
            **{fam: getattr(f, FAMILY[fam])(**args) for fam, args in faults.items()})
        sched = None if schedule is None else [
            s.RoundEvents(active=np.asarray(a, bool), dropped=np.asarray(d, bool),
                          joined=np.asarray(j, bool)) for a, d, j in schedule]
        out.append(s.ScenarioConfig(faults=fc, schedule=sched, **kw))
    return tuple(out)


ALL_FAULTS = dict(
    drift=dict(worker=2, round=3, factor=2.5, mode="ramp", ramp_rounds=3),
    crash=dict(rate=0.2, outage_rounds=2, recovery_rounds=2),
    outage=dict(start=4, length=3, slot_lo=1, slot_hi=4),
    wave=dict(amplitude=0.5, period=5),
    byzantine=dict(fraction=0.3, mode="scale", scale=-5.0),
    channel=dict(drop=0.3, dup=0.2, corrupt=0.1, max_retries=2),
)

DRAW_CASES = {
    "sampling": dict(participation=0.5, seed=1),
    "dropout": dict(participation=0.8, dropout=0.4, seed=2),
    "churn": dict(participation=0.7, churn=0.25, seed=3),
    "schedule": dict(schedule=[([1, 0, 1, 1, 0, 0, 1], [0, 0, 1, 0, 0, 0, 0], [0] * 7),
                               ([1, 1, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 0, 0])]),
    "drift_jump": dict(faults=dict(drift=dict(worker=6, round=5, factor=0.5))),
    "drift_ramp": dict(faults=dict(drift=ALL_FAULTS["drift"])),
    "crash": dict(participation=0.9, seed=4, faults=dict(crash=dict(rate=0.3, outage_rounds=1))),
    "outage": dict(min_participants=5, seed=5, faults=dict(outage=ALL_FAULTS["outage"])),
    "wave": dict(participation=0.6, seed=6, faults=dict(wave=ALL_FAULTS["wave"])),
    "byzantine_fixed": dict(faults=dict(byzantine=dict(workers=(0, 5), mode="sign_flip"))),
    "byzantine_fraction": dict(seed=7, faults=dict(byzantine=ALL_FAULTS["byzantine"])),
    "channel": dict(participation=0.8, seed=8, faults=dict(channel=ALL_FAULTS["channel"])),
    "combined": dict(participation=0.8, dropout=0.2, churn=0.1, min_participants=3, seed=9,
                     faults=ALL_FAULTS),
}


def assert_events_equal(a, b, where):
    for name in EVENT_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or y is None:
            assert x is None and y is None, (where, name)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (where, name)
        else:
            assert x == y, (where, name)
    np.testing.assert_array_equal(a.submitters, b.submitters, err_msg=str(where))


@pytest.mark.parametrize("case", list(DRAW_CASES))
def test_scenario_engine_draws_identical_events(case):
    """Every RoundEvents field, 12 rounds, with churn's fresh shards drawn
    between rounds on the shared stream as the round loop draws them."""
    jc, tc = scenario_pair(**DRAW_CASES[case])
    je, te = jsc.ScenarioEngine(jc, W), tsc.ScenarioEngine(tc, W)
    fired = False
    for t in range(1, 13):
        a, b = je.draw(t), te.draw(t)
        assert_events_equal(a, b, (case, t))
        for w in np.flatnonzero(a.joined):
            np.testing.assert_array_equal(je.fresh_shard(20, 300), te.fresh_shard(20, 300))
        fired |= bool(a.joined.any() or a.skip or a.degraded or a.drift_changed
                      or (a.byz is not None and a.byz.any()) or not a.active.all())
    assert fired, "the case must change some round"
    assert je.rng.random() == te.rng.random() and je.fault_rng.random() == te.fault_rng.random()


def test_draw_all_equals_the_lazy_draws():
    jc, tc = scenario_pair(**DRAW_CASES["combined"])
    sizes = [30] * W
    lazy_eng = tsc.ScenarioEngine(tc, W)
    plan = tsc.ScenarioEngine(tc, W).draw_all(12, sizes, train_len=300)
    jplan = jsc.ScenarioEngine(jc, W).draw_all(12, sizes, train_len=300)
    assert sum(len(s) for s in plan.fresh_shards) > 0
    for t in range(1, 13):
        ev = lazy_eng.draw(t)
        assert_events_equal(ev, plan.events[t - 1], ("lazy", t))
        assert_events_equal(jplan.events[t - 1], plan.events[t - 1], ("jax", t))
        fresh = {int(w): lazy_eng.fresh_shard(30, 300) for w in np.flatnonzero(ev.joined)}
        assert sorted(fresh) == sorted(plan.fresh_shards[t - 1])
        for w, sh in fresh.items():
            np.testing.assert_array_equal(sh, plan.fresh_shards[t - 1][w])
            np.testing.assert_array_equal(sh, jplan.fresh_shards[t - 1][w])
    for k, v in plan.as_arrays().items():
        np.testing.assert_array_equal(v, jplan.as_arrays()[k], err_msg=k)
    full = tsc.ScenarioPlan.full(3, 4)
    assert len(full.events) == 3 and full.as_arrays()["submitters"].all()
    with pytest.raises(ValueError, match="shard_sizes"):
        tsc.ScenarioEngine(scenario_pair(churn=0.9, seed=1)[1], W).draw_all(4)


@pytest.mark.parametrize("n,workers,alpha,seed", [(1280, 10, 0.5, 0), (1000, 7, 0.1, 3),
                                                  (96, 5, 5.0, 1), (503, 4, 1.0, 2)])
def test_partition_dirichlet_byte_identical(n, workers, alpha, seed):
    y = np.random.default_rng(seed).integers(0, 10, n).astype(np.int32)
    a = jsyn.partition_dirichlet(y, workers, alpha, seed)
    b = tsyn.partition_dirichlet(y, workers, alpha, seed)
    assert len(a) == len(b) == workers
    for x, z in zip(a, b):
        assert x.dtype == z.dtype and x.tobytes() == z.tobytes()
        assert len(z) == n // workers


def test_timing_pieces_equal():
    for args in [(2, 3, 4.0), (3, 3, 4.0), (9, 3, 4.0), (4, 3, 4.0, 3), (5, 3, 0.5, 4),
                 (1, 1, 2.0, 1), (7, 2, 3.0, 9)]:
        assert jtm.drift_multiplier(*args) == ttm.drift_multiplier(*args), args
    for Wn, sigma in [(1, 2.0), (2, 2.0), (10, 2.0), (10, 5.5), (37, 1.0)]:
        assert jtm.heterogeneity_closed_form(Wn, sigma) == ttm.heterogeneity_closed_form(Wn, sigma)
    bws = jtm.make_bandwidths(jtm.HeterogeneityConfig(num_workers=6, sigma=3.0), 5e5, 1.0)
    kw = dict(bandwidths=bws, t_train_full=1.3, model_bytes_fn=lambda g: 5e5 * g ** 2,
              flops_fn=lambda g: 1e9 * g, train_sens=0.4, jitter=0.05)
    jm, tm = jtm.ChannelModel(**kw), ttm.ChannelModel(**kw)
    rj, rt = np.random.default_rng(4), np.random.default_rng(4)
    for w in range(6):
        for g in (1.0, 0.7, 0.31):
            assert jm.train_time(g) == tm.train_time(g)
            assert jm.comm_time(w, g) == tm.comm_time(w, g)
            assert jm.update_time(w, g) == tm.update_time(w, g)
            assert jm.update_time(w, g, rj) == tm.update_time(w, g, rt)


def test_fault_ledger_equal():
    jc, tc = scenario_pair(**DRAW_CASES["combined"])
    je, te = jsc.ScenarioEngine(jc, W), tsc.ScenarioEngine(tc, W)
    jev = [je.draw(t) for t in range(1, 13)]
    tev = [te.draw(t) for t in range(1, 13)]
    led = tf.fault_ledger(tev)
    assert led == jf.fault_ledger(jev)
    assert led["workers_recovered"] > 0 and led["retry_total"] > 0 and led["byz_commits"] > 0
    assert tf.fault_ledger([tsc.full_participation(4)]) == jf.fault_ledger(
        [jsc.full_participation(4)]) == {f: 0 for f in LEDGER_FIELDS[:-1]}


VALIDATION_CASES = [
    ("DriftConfig", dict(factor=0.0)), ("DriftConfig", dict(mode="teleport")),
    ("DriftConfig", dict(mode="ramp", ramp_rounds=0)), ("DriftConfig", dict(worker=-1)),
    ("DriftConfig", dict(round=0)),
    ("CrashConfig", dict(rate=1.0)), ("CrashConfig", dict(outage_rounds=0)),
    ("CrashConfig", dict(recovery_rounds=-1)),
    ("OutageConfig", dict(start=1, length=0, slot_lo=0, slot_hi=1)),
    ("OutageConfig", dict(start=1, length=1, slot_lo=2, slot_hi=2)),
    ("OutageConfig", dict(start=0)),
    ("WaveConfig", dict(amplitude=1.0)), ("WaveConfig", dict(period=1)),
    ("ByzantineConfig", dict(workers=())), ("ByzantineConfig", dict(fraction=1.5)),
    ("ByzantineConfig", dict(mode="lie")), ("ByzantineConfig", dict(mode="scale", scale=0.0)),
    ("ByzantineConfig", dict(noise_std=0.0)),
    ("ChannelConfig", dict(drop=1.0)), ("ChannelConfig", dict(dup=-0.1)),
    ("ChannelConfig", dict(max_retries=-1)), ("ChannelConfig", dict(retry_backoff=-1.0)),
    ("ChannelConfig", dict(corrupt_std=0.0)),
    ("for_shard", dict(start=1, length=1, shard=0, num_workers=6, num_shards=4)),
    ("for_shard", dict(start=1, length=1, shard=3, num_workers=6, num_shards=3)),
    ("engine", dict(participation=0.0)), ("engine", dict(dropout=1.0)),
    ("engine", dict(churn=1.0)), ("engine", dict(min_participants=0)),
    ("engine", dict(timeout_factor=0.5)), ("engine", dict(skew=0.0)),
    ("engine", dict(faults=dict(drift=dict(worker=7)))),
    ("engine", dict(faults=dict(outage=dict(start=1, length=1, slot_lo=0, slot_hi=9)))),
    ("engine", dict(faults=dict(byzantine=dict(workers=(1, 7))))),
]


def _build(f, s, kind, kw):
    if kind == "for_shard":
        return f.OutageConfig.for_shard(**kw)
    if kind == "engine":
        faults = kw.pop("faults", None)
        fc = None if faults is None else f.FaultConfig(
            **{fam: getattr(f, FAMILY[fam])(**args) for fam, args in faults.items()})
        return s.ScenarioEngine(s.ScenarioConfig(faults=fc, **kw), W)
    return getattr(f, kind)(**kw)


@pytest.mark.parametrize("kind,kw", VALIDATION_CASES)
def test_config_validations_raise_alike(kind, kw):
    msgs = []
    for f, s in ((jf, jsc), (tf, tsc)):
        with pytest.raises(ValueError) as err:
            _build(f, s, kind, dict(kw))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_fault_config_helpers_equal():
    for f in (jf, tf):
        assert not f.FaultConfig().any_active and f.FaultConfig(wave=f.WaveConfig()).any_active
    o = tf.OutageConfig.for_shard(start=2, length=3, shard=1, num_workers=8, num_shards=4)
    assert (o.slot_lo, o.slot_hi) == (2, 4)
    assert [o.covers(t) for t in range(1, 7)] == [False, True, True, True, False, False]
    for t in range(1, 12):
        assert tf.WaveConfig(0.4, 5).factor_at(t) == jf.WaveConfig(0.4, 5).factor_at(t)
        d = dict(worker=0, round=3, factor=4.0, mode="ramp", ramp_rounds=3)
        assert tf.DriftConfig(**d).mult_at(t) == jf.DriftConfig(**d).mult_at(t)
    assert tf.ByzantineConfig(workers=[3, 1]).workers == (3, 1)


# ---------------------------------------------------------------------------
# whole runs, port engine against the JAX engine of the same name
# ---------------------------------------------------------------------------

RUN_CASES = {
    "sampling_dropout_churn": dict(participation=0.6, dropout=0.2, churn=0.15,
                                   timeout_factor=1.7, seed=4),
    "skew": dict(skew=0.3, participation=0.8, seed=2),
}
ENGINES = ("sequential", "bucketed", "masked")
PLAN = [16, "M", 32]


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case, engine):
        if (case, engine) not in cache:
            seed, Wn = 3, 5
            jcfg = jcnn.vgg_config("t", PLAN, num_classes=10, image_size=8)
            tcfg = tcnn.vgg_config("t", PLAN, num_classes=10, image_size=8)
            jscen, tscen = scenario_pair(**RUN_CASES[case])
            kw = dict(method="adaptcl", importance="index", rounds=6, prune_interval=2,
                      num_workers=Wn, batch_size=8, eval_every=1, seed=seed, engine=engine)
            task = dict(num_classes=10, image_size=8, train_size=100, test_size=64, seed=seed)
            base = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg).items()}
            rj = j_run(JSimConfig(cnn=jcfg, task=jsyn.SyntheticImageTask(**task), scenario=jscen,
                                  het=jtm.HeterogeneityConfig(num_workers=Wn), **kw))
            rt = t_run(TSimConfig(cnn=tcfg, task=tsyn.SyntheticImageTask(**task), scenario=tscen,
                                  het=ttm.HeterogeneityConfig(num_workers=Wn), device="cpu",
                                  compute="block_skip" if engine == "masked" else "dense", **kw),
                       base_params=base)
            cache[(case, engine)] = (rj, rt)
        return cache[(case, engine)]

    return get


def assert_contract(rj, rt):
    """ROADMAP's parity contract plus scenario rounds, ledger and params."""
    assert rt.prune_events == rj.prune_events
    assert rt.scenario_rounds == rj.scenario_rounds
    assert {f: getattr(rt, f) for f in LEDGER_FIELDS} == {f: getattr(rj, f) for f in LEDGER_FIELDS}
    np.testing.assert_allclose(np.array(rt.update_times), np.array(rj.update_times),
                               rtol=0, atol=0, equal_nan=True)
    assert abs(rt.total_time - rj.total_time) <= 1e-9
    assert [t for t, _ in rt.acc_time] == [t for t, _ in rj.acc_time]
    assert rt.comm_bytes == rj.comm_bytes and rt.retentions == rj.retentions
    assert rt.het_traj == rj.het_traj
    assert abs(rt.final_acc - rj.final_acc) <= 1e-3
    for k in rj.global_params:
        np.testing.assert_allclose(rt.global_params[k], rj.global_params[k], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", list(RUN_CASES))
def test_scenario_run_matches_jax_engine(case, engine, runs):
    rj, rt = runs(case, engine)
    assert_contract(rj, rt)
    assert rt.prune_events and min(rt.retentions) < 1.0, "the case must prune"
    rows = np.array(rt.scenario_rounds)
    assert len(rows) == 6 and (rows[:, 1] < 5).any(), "the case must sample"
    if case == "sampling_dropout_churn":
        assert rows[:, 2].sum() > 0 and rows[:, 3].sum() > 0, "the case must drop and churn"


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", list(RUN_CASES))
def test_scenario_run_counters_match_jax_engine(case, engine, runs):
    rj, rt = runs(case, engine)
    assert rt.recompiles == rj.recompiles
    assert rt.host_dispatches == rj.host_dispatches
    assert rt.batched_calls == rj.batched_calls
    assert rt.bucket_sizes == rj.bucket_sizes
    assert rt.host_roundtrips == rj.host_roundtrips
    assert rt.flops_ideal == rj.flops_ideal
    if engine == "masked":
        assert rt.host_roundtrips == 0 and min(rt.bucket_sizes) < 5


def test_skew_partitioner_is_refused_beside_noniid():
    _, tscen = scenario_pair(skew=0.5)
    sim = TSimConfig(rounds=1, num_workers=2, device="cpu", noniid_s=80.0, scenario=tscen)
    with pytest.raises(ValueError, match="competing Non-IID"):
        t_run(sim)
