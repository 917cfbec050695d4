"""The sync fault families on the port against the JAX package.

``tests/test_faults.py``'s ``FAMILIES`` (drift, crash, outage, wave,
combined), both packages from the JAX ``init_cnn`` draw:

* at that file's own size (W=5, 8 rounds, the default task), the port's
  ``sequential`` engine and its ``masked`` engine with ``compute="block_skip"``
  against JAX ``sequential`` (ROADMAP's oracle for the fault families):
  identical prune events, ``scenario_rounds`` and fault ledger, update times
  equal at atol 0 with NaNs in place, total time within 1e-9;
* at a smaller task (160 training images, two steps a round), the full
  contract — those fields plus final_acc within 1e-3 and global params
  within 1e-4 — on the port's ``sequential`` against JAX ``sequential`` and
  the port's ``masked`` (``block_skip``) against JAX ``masked`` (dense).

Why two sizes: at the larger one, 16 SGD steps a round for 8 rounds, float32
training here is chaotic.  A 1e-7 relative change of the init moves the
params by 5e-4 within two rounds, and in the crash world one worker's round-5
step turns a 1e-7 input change into 5e-5.  Summation order alone (XLA's
convolution, the port's grouped convolution, the block-skip im2col product,
a stack of 1 or 2 rows) then decides accuracy and params to ~1e-2, as it
does between the reference's own engines (ROADMAP queue C); the events,
clocks and ledgers stay exact.

Then the goldens of ``tests/test_faults.py`` mirrored on the port, and the
byzantine and channel families refused by field name where the reference
refuses them (by_unit aggregation).
"""
import jax
import numpy as np
import pytest
import torch
from torch_envelope import assert_within_envelope, params_maxdiff, perturbations

from repro.core import faults as jf
from repro.core import scenario as jsc
from repro.core import simulation as jsim
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import run_simulation as j_run
from repro.core.timing import HeterogeneityConfig as JHet
from repro.data.synthetic import SyntheticImageTask as JTask
from repro.models import cnn as jcnn
from repro_torch.core import faults as tf
from repro_torch.core import scenario as tsc
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import run_simulation as t_run
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


PLAN = [8, "M", 16]
LEDGER_FIELDS = ("drift_events", "rounds_degraded", "rounds_skipped", "workers_recovered",
                 "retry_total", "byz_commits", "lost_commits", "dup_commits", "corrupt_commits")
FAULTS = {
    "DRIFT": dict(drift=dict(worker=1, round=3, factor=3.0)),
    "CRASH": dict(crash=dict(rate=0.25, outage_rounds=2, recovery_rounds=1)),
    "OUTAGE": dict(outage=dict(start=3, length=2, slot_lo=0, slot_hi=3)),
    "WAVE": dict(wave=dict(amplitude=0.6, period=4)),
    "COMBINED": dict(drift=dict(worker=0, round=3, factor=2.0, mode="ramp", ramp_rounds=3),
                     crash=dict(rate=0.15),
                     outage=dict(start=5, length=2, slot_lo=2, slot_hi=5),
                     wave=dict(amplitude=0.4, period=5)),
}
FAMILIES = {
    "drift": dict(seed=3, faults="DRIFT"),
    "crash": dict(seed=3, faults="CRASH"),
    "outage": dict(seed=3, min_participants=4, faults="OUTAGE"),
    "wave": dict(seed=3, participation=0.7, faults="WAVE"),
    "combined": dict(seed=3, min_participants=4, participation=0.9, faults="COMBINED"),
}
CLASSES = {"drift": "DriftConfig", "crash": "CrashConfig", "outage": "OutageConfig",
           "wave": "WaveConfig", "byzantine": "ByzantineConfig", "channel": "ChannelConfig"}
SMALL_TASK = dict(num_classes=4, image_size=8, train_size=160, test_size=128, seed=5)


def scenario(pkg, faults=None, **kw):
    """ScenarioConfig of ``pkg`` ("jax" | "port"); ``faults`` names a
    FAULTS entry or maps families to kwargs."""
    f, s = (jf, jsc) if pkg == "jax" else (tf, tsc)
    spec = FAULTS[faults] if isinstance(faults, str) else faults
    fc = None if spec is None else f.FaultConfig(
        **{fam: getattr(f, CLASSES[fam])(**args) for fam, args in spec.items()})
    return s.ScenarioConfig(faults=fc, **kw)


def _base(engine, **kw):
    base = dict(method="adaptcl", engine=engine, rounds=8, prune_interval=2, num_workers=5,
                batch_size=16, eval_every=2, seed=5)
    base.update(kw)
    return base


def ulp(params, bump):
    """``params`` moved one ulp toward +inf (``bump="up"``) or -inf
    (``"down"``); ``params`` as they are for ``bump=None``."""
    if bump is None:
        return params
    to = np.float32(np.inf if bump == "up" else -np.inf)
    return {k: np.nextafter(np.asarray(v, np.float32), to) for k, v in params.items()}


def jax_sim(engine, scen_kw, task=None, bump=None, **kw):
    """The reference; ``bump`` moves its init draw one ulp (see ``ulp``)."""
    cfg = jcnn.vgg_config("vgg_tiny_flt", PLAN, num_classes=4, image_size=8)
    extra = {} if task is None else dict(task=JTask(**task))
    draw = jsim.init_cnn
    if bump is not None:
        jsim.init_cnn = lambda key, c: ulp(draw(key, c), bump)
    try:
        return j_run(JSimConfig(cnn=cfg, het=JHet(num_workers=5, sigma=3.0),
                                scenario=scenario("jax", **scen_kw), **extra,
                                **_base(engine, **kw)))
    finally:
        jsim.init_cnn = draw


_INIT = {}


def port_sim(engine, scen_kw, task=None, bump=None, **kw):
    """The port from the JAX init draw (moved by ``bump``, see ``ulp``); the
    masked engine runs block_skip."""
    base = _base(engine, **kw)
    jcfg = jcnn.vgg_config("vgg_tiny_flt", PLAN, num_classes=4, image_size=8)
    seed = base["seed"]
    if seed not in _INIT:
        _INIT[seed] = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg).items()}
    extra = {} if task is None else dict(task=TTask(**task))
    compute = "block_skip" if engine == "masked" else "dense"
    return t_run(TSimConfig(cnn=tcnn.vgg_config("vgg_tiny_flt", PLAN, num_classes=4, image_size=8),
                            het=THet(num_workers=5, sigma=3.0), scenario=scenario("port", **scen_kw),
                            device="cpu", compute=compute, **extra, **base),
                 base_params=ulp(_INIT[seed], bump))


def ledger(r):
    return {f: getattr(r, f) for f in LEDGER_FIELDS}


def assert_events_and_clocks(ref, other):
    assert ref.prune_events == other.prune_events
    assert ref.scenario_rounds == other.scenario_rounds
    assert ledger(ref) == ledger(other)
    np.testing.assert_allclose(np.array(ref.update_times), np.array(other.update_times),
                               rtol=0, atol=0, equal_nan=True)
    assert abs(ref.total_time - other.total_time) <= 1e-9
    assert [t for t, _ in ref.acc_time] == [t for t, _ in other.acc_time]


@pytest.fixture(scope="module")
def cache():
    store = {}

    def get(key, fn, *args, **kw):
        if key not in store:
            store[key] = fn(*args, **kw)
        return store[key]

    return get


# ---------------------------------------------------------------------------
# FAMILIES against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["sequential", "masked"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_families_events_and_clocks_equal_jax_sequential(family, engine, cache):
    ref = cache(("jax", family), jax_sim, "sequential", FAMILIES[family])
    port = cache(("port", family, engine), port_sim, engine, FAMILIES[family])
    assert_events_and_clocks(ref, port)
    assert port.prune_events
    assert np.isfinite(port.final_acc)


@pytest.mark.parametrize("engine", ["sequential", "masked"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_families_match_jax_engine_within_contract(family, engine):
    ref = jax_sim(engine, FAMILIES[family], task=SMALL_TASK)
    port = port_sim(engine, FAMILIES[family], task=SMALL_TASK)
    assert_events_and_clocks(ref, port)
    assert abs(ref.final_acc - port.final_acc) <= 1e-3
    for k in ref.global_params:
        np.testing.assert_allclose(port.global_params[k], ref.global_params[k], atol=1e-4,
                                   err_msg=k)
    assert port.prune_events
    fired = {"drift": port.drift_events, "crash": port.workers_recovered,
             "outage": port.rounds_skipped, "combined": port.rounds_degraded,
             "wave": sum(n < 5 for _, n, _, _ in port.scenario_rounds)}[family]
    assert fired > 0, f"the {family} family must change some round"
    if engine == "masked":
        assert port.host_roundtrips == 0
        # partial cohorts train as row buckets gathered from the stacks
        assert (min(port.bucket_sizes) < 5) == (family in ("crash", "wave", "combined"))


# ---------------------------------------------------------------------------
# the crash world at test_faults' size (ROADMAP queue C)
# ---------------------------------------------------------------------------

def _jax_crash(engine, cache, bump=None):
    """The reference's crash world, one run per (engine, bump) for the
    module (JAX sequential from the init is the families' own run)."""
    key = ("jax", "crash") if (engine, bump) == ("sequential", None) else (
        "jax", "crash", engine, bump)
    return cache(key, jax_sim, engine, FAMILIES["crash"], bump=bump)


@pytest.mark.parametrize("bump", [pytest.param(None, id="None-True"),
                                  pytest.param("up", id="up-False"),
                                  pytest.param("down", id="down-False")])
def test_crash_world_reference_engines_part_on_the_last_bit(bump, cache):
    """At test_faults' size the crash world ends on one of a few sides, and
    which one an engine takes is decided by the last bits of its sums: a
    ReLU gate within 1e-7 of zero flips with a convolution's summation
    order, which XLA picks by ISA.  So whether the reference's sequential
    and masked engines part from the seeded init (final_acc 0.7480 against
    0.7422 on one CPU, params 1.6e-2 apart from the init on another, where
    the one-ulp inits agree within 5e-7) depends on the CPU, and no bar on
    their params at this size holds on every one.  What holds on every
    CPU, from the init and from it moved one ulp either way: at this size
    the two engines' events, clocks and ledgers are equal; at the 160-image
    task, where no gate sits that close to zero, their params and
    final_acc also lie within the reference's 1e-4 and 1e-3.  A port
    engine landing on the other-named JAX engine is no witness of swapped
    semantics."""
    seq = _jax_crash("sequential", cache, bump)
    msk = _jax_crash("masked", cache, bump)
    assert_events_and_clocks(seq, msk)
    small = {e: cache(("jax", "crash", "small", e, bump), jax_sim, e, FAMILIES["crash"],
                      task=SMALL_TASK, bump=bump) for e in ("sequential", "masked")}
    assert_events_and_clocks(small["sequential"], small["masked"])
    assert small["sequential"].workers_recovered > 0
    assert params_maxdiff(small["sequential"], small["masked"]) <= 1e-4, f"init {bump}"
    assert abs(small["sequential"].final_acc - small["masked"].final_acc) <= 1e-3, f"init {bump}"


@pytest.mark.parametrize("engine", ["sequential", "masked"])
def test_crash_world_full_size_contract_from_the_init_one_ulp_down(engine, cache):
    """From the init itself each port engine has the events, clocks and
    ledgers of the JAX engine of the same name at test_faults' own size,
    crash recovery included, and params and final_acc within 1e-4 and 1e-3
    of JAX sequential (the fault families' oracle), or within 2x the
    envelope where that is larger: the port's own runs from the init one
    ulp up and down and in the other summation order."""
    ref = _jax_crash(engine, cache)
    port = cache(("port", "crash", engine), port_sim, engine, FAMILIES["crash"])
    assert_events_and_clocks(ref, port)
    seq = _jax_crash("sequential", cache)
    assert_within_envelope(
        port, seq, bar=1e-4, what=f"crash/{engine}",
        perturbed=perturbations(lambda b: port_sim(engine, FAMILIES["crash"], bump=b)))
    assert port.workers_recovered > 0


# ---------------------------------------------------------------------------
# goldens of tests/test_faults.py, on the port
# ---------------------------------------------------------------------------

def test_inactive_faultconfig_is_bit_identical_to_none():
    base = dict(participation=0.8, dropout=0.2, seed=2)
    a = port_sim("sequential", base)
    b = port_sim("sequential", dict(faults={}, **base))
    assert a.final_acc == b.final_acc and a.total_time == b.total_time
    assert a.prune_events == b.prune_events
    np.testing.assert_array_equal(np.array(a.update_times), np.array(b.update_times))
    assert ledger(b) == {f: 0 for f in LEDGER_FIELDS}


def test_fault_stream_leaves_base_draws_untouched():
    cfg = dict(participation=0.8, dropout=0.3, churn=0.1, seed=7)
    plain = tsc.ScenarioEngine(scenario("port", **cfg), 6)
    faulty = tsc.ScenarioEngine(
        scenario("port", faults=dict(crash=dict(rate=0.4, outage_rounds=1)), **cfg), 6)
    for t in range(1, 12):
        ep, ef = plain.draw(t), faulty.draw(t)
        on = ~ef.offline
        np.testing.assert_array_equal(ep.active & on, ef.active)
        np.testing.assert_array_equal(ep.joined & on, ef.joined)
        assert not (ef.active & ef.offline).any()


@pytest.mark.parametrize("engine", ["sequential", "masked"])
def test_drift_triggers_relearning_within_one_interval(engine, cache):
    """Worker 1 slows 3x at round 3, mid-interval under PI=2: Alg. 2 re-runs
    at round 3 with its history invalidated, so worker 1 prunes at round 4,
    a round where the fault-free run prunes nobody."""
    r = cache(("port", "drift", engine), port_sim, engine, FAMILIES["drift"])
    assert r.drift_events == 1 and r.rounds_skipped == 0
    assert any(rnd == 4 and w == 1 for rnd, w, _ in r.prune_events), r.prune_events
    free = port_sim(engine, dict(seed=3))
    assert not any(rnd == 4 for rnd, _, _ in free.prune_events), free.prune_events


def test_outage_below_floor_skips_and_advances(cache):
    r = cache(("port", "outage", "sequential"), port_sim, "sequential", FAMILIES["outage"])
    assert r.rounds_skipped == 2 and r.rounds_degraded == 0
    ut = np.array(r.update_times)
    assert np.isnan(ut[2]).all() and np.isnan(ut[3]).all()
    assert not np.isnan(ut[4]).all()
    assert r.total_time > 0.0
    assert r.workers_recovered == 3
    assert len(r.scenario_rounds) == 8


def test_outage_above_floor_degrades_gracefully():
    r = port_sim("masked", dict(seed=3, min_participants=1, faults="OUTAGE"))
    assert r.rounds_skipped == 0 and r.rounds_degraded >= 2
    ut = np.array(r.update_times)
    assert np.isnan(ut[2, :3]).all() and np.isfinite(ut[2, 3:]).any()


def test_crash_recovery_ledger_and_reentry(cache):
    r = cache(("port", "crash", "sequential"), port_sim, "sequential", FAMILIES["crash"])
    assert r.workers_recovered > 0
    assert r.retry_total == r.workers_recovered
    assert r.rounds_degraded > 0 and r.rounds_skipped == 0


def test_fault_ledger_pure_function():
    eng = tsc.ScenarioEngine(scenario("port", seed=3, min_participants=4, faults="OUTAGE"), 5)
    led = tf.fault_ledger([eng.draw(t) for t in range(1, 9)])
    assert led["rounds_skipped"] == 2 and led["workers_recovered"] == 3
    assert tf.fault_ledger([tsc.full_participation(4)]) == {f: 0 for f in LEDGER_FIELDS}


# ---------------------------------------------------------------------------
# what stays refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,args", [("byzantine", dict(workers=(1,))),
                                         ("channel", dict(drop=0.2))])
@pytest.mark.parametrize("engine", ["sequential", "masked"])
def test_byzantine_and_channel_are_refused_by_name(family, args, engine):
    """The byzantine and channel families run (tests/test_torch_robust_*.py);
    the reference refuses them, by name, under by_unit aggregation, which
    has no per-worker delta to perturb."""
    sim = TSimConfig(rounds=1, num_workers=2, device="cpu", engine=engine,
                     aggregation="by_unit", scenario=scenario("port", faults={family: args}))
    with pytest.raises(ValueError, match=rf"FaultConfig\.{family} perturbs per-worker commit"):
        t_run(sim)
    jsim_cfg = JSimConfig(rounds=1, num_workers=2, engine=engine, aggregation="by_unit",
                          scenario=scenario("jax", faults={family: args}))
    with pytest.raises(ValueError, match=rf"FaultConfig\.{family} perturbs per-worker commit"):
        j_run(jsim_cfg)


@pytest.mark.parametrize("engine", ["sequential", "bucketed"])
def test_resident_momentum_needs_the_masked_engine(engine):
    sim = TSimConfig(rounds=1, num_workers=2, device="cpu", engine=engine, resident_momentum=True)
    with pytest.raises(ValueError, match=r"SimConfig\.resident_momentum needs the resident"):
        t_run(sim)
