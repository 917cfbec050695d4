"""The port's fused async engine (the device event queue) against the JAX
fused engine.

fedasync_s, ssp_s and dcasgd_s at ``tests/test_torch_async.py``'s config (a
tiny VGG, 5 slots, 160 images), both packages from the JAX init: under the
fleet scenario (a 4-of-5 cohort, timed-out commits, crashes) with a 0.3 s
window, serially, and with a window wide enough to batch 6 workers.  Each
run against JAX fused: total time within 1e-9, every eval clock identical,
final_acc within 1e-3, global params within 1e-4, identical scenario rounds,
fault ledger, bucket sizes, ``host_dispatches``, ``fused_chunks``,
``recompiles`` and ``comm_bytes``.  Also the uniform-phi golden where every
first-wave finish ties (the heap's ``(time, worker)`` order), dispatches
that scale with chunks, the empty-plan commit, and the per-chunk check:
a plan whose commit order or staleness the device queue does not reproduce
raises.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import faults as jf
from repro.core import scenario as jsc
from repro.core import simulation as jsim
from repro.core.timing import HeterogeneityConfig as JHet
from repro.data.synthetic import SyntheticImageTask as JTask
from repro.models import cnn as jcnn
from repro_torch.core import faults as tf
from repro_torch.core import scenario as tsc
from repro_torch.core import simulation as tsim
from repro_torch.core.timing import HeterogeneityConfig as THet
from repro_torch.data.synthetic import SyntheticImageTask as TTask
from repro_torch.models import cnn as tcnn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
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
FLEET = dict(scen=dict(participation=0.8, dropout=0.2, seed=2),
             crash=dict(rate=0.3, outage_rounds=2))
RUNS = {
    "fleet_window": dict(async_window=0.3, **FLEET),
    "serial": dict(async_window=0.0),
    "wide_window": dict(async_window=50.0, W=6, rounds=3),
}


def scenario(pkg, scen=None, crash=None):
    if scen is None:
        return None
    f, s = (jf, jsc) if pkg == "jax" else (tf, tsc)
    fc = f.FaultConfig(crash=f.CrashConfig(**crash)) if crash is not None else None
    return s.ScenarioConfig(faults=fc, **scen)


def configs(method, W=5, scen=None, crash=None, sigma=3.0, **kw):
    base = dict(method=method, engine="fused", rounds=4 if method == "ssp_s" else 2,
                num_workers=W, batch_size=16, eval_every=2, seed=SEED)
    base.update(kw)
    jc = jsim.SimConfig(cnn=jcnn.vgg_config("tiny_async", PLAN, num_classes=4, image_size=8),
                        het=JHet(num_workers=W, sigma=sigma), task=JTask(**TASK),
                        scenario=scenario("jax", scen, crash), **base)
    tc = tsim.SimConfig(cnn=tcnn.vgg_config("tiny_async", PLAN, num_classes=4, image_size=8),
                        het=THet(num_workers=W, sigma=sigma), task=TTask(**TASK),
                        scenario=scenario("port", scen, crash), device="cpu", **base)
    return jc, tc


_INIT = {}


def jax_init(jc):
    if not _INIT:
        _INIT["p"] = {k: np.asarray(v) for k, v in
                      jcnn.init_cnn(jax.random.PRNGKey(SEED), jc.cnn).items()}
    return _INIT["p"]


def pair(method, **kw):
    jc, tc = configs(method, **kw)
    return jsim.run_simulation(jc), tsim.run_simulation(tc, base_params=jax_init(jc))


def assert_matches(rj, rt):
    assert abs(rt.total_time - rj.total_time) <= 1e-9
    assert [t for t, _ in rt.acc_time] == [t for t, _ in rj.acc_time]
    assert abs(rt.final_acc - rj.final_acc) <= 1e-3
    for k in rj.global_params:
        np.testing.assert_allclose(rt.global_params[k], rj.global_params[k], atol=1e-4,
                                   err_msg=k)
    assert rt.scenario_rounds == rj.scenario_rounds
    assert {f: getattr(rt, f) for f in LEDGER_FIELDS} == {f: getattr(rj, f) for f in LEDGER_FIELDS}
    assert rt.bucket_sizes == rj.bucket_sizes
    assert rt.host_dispatches == rj.host_dispatches
    assert rt.fused_chunks == rj.fused_chunks
    assert rt.recompiles == rj.recompiles
    assert rt.comm_bytes == rj.comm_bytes and rt.flops_ideal == rj.flops_ideal
    assert rt.host_roundtrips == rj.host_roundtrips == 0
    assert rt.prune_events == [] and rt.engine == "fused"


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("method", METHODS)
def test_async_fused_matches_jax_fused(method, run):
    kw = dict(RUNS[run])
    rj, rt = pair(method, **kw)
    assert_matches(rj, rt)
    if run == "fleet_window":
        assert rt.workers_recovered > 0 and rt.scenario_rounds == [(0, 4, 0, 0)]
    if run == "wide_window":
        assert rt.bucket_sizes == [6]


def test_async_fused_golden_tiebreak():
    """Uniform phi (sigma=1, no jitter): every first-wave finish ties and the
    commits pop in ascending slot order, the heap's ``(time, worker)``
    order, on both packages' device queues."""
    kw = dict(W=8, sigma=1.0, time_jitter=0.0, async_window=1000.0)
    rj, rt = pair("fedasync_s", **kw)
    assert_matches(rj, rt)
    jc, tc = configs("fedasync_s", **kw)
    env = tsim._Env(tc, base_params=jax_init(jc))
    plan = tsim._plan_async_events(tc, env, None, np.arange(8))
    assert len(set(plan.finishes[:8].tolist())) == 1
    np.testing.assert_array_equal(plan.workers, np.tile(np.arange(8), tc.rounds))


def test_async_fused_dispatches_scale_with_chunks_not_events():
    jc, tc = configs("fedasync_s", W=4, round_fusion=4)
    fus = tsim.run_simulation(tc, base_params=jax_init(jc))
    tc.engine = "masked"
    mas = tsim.run_simulation(tc, base_params=jax_init(jc))
    events = 4 * 2
    eval_calls = (2 + 1) * 1       # the initial eval and one per 4 commits, one batch each
    assert fus.fused_chunks == events // 4
    assert fus.host_dispatches == fus.fused_chunks + eval_calls
    assert mas.host_dispatches == events + eval_calls
    assert fus.recompiles == 1
    assert fus.total_time == mas.total_time


def test_async_fused_empty_plans_commit_the_fetched_params():
    rj, rt = pair("fedasync_s", rounds=1, W=2, local_epochs=0.0)
    assert_matches(rj, rt)


def test_device_queue_divergence_raises(monkeypatch):
    """A plan whose staleness the device queue does not reproduce (one
    integer changed after planning) stops the run at the chunk check."""
    real = tsim._plan_async_events

    def tampered(*args, **kw):
        plan = real(*args, **kw)
        plan.staleness[-1] += 1
        return plan

    monkeypatch.setattr(tsim, "_plan_async_events", tampered)
    jc, tc = configs("ssp_s")
    with pytest.raises(RuntimeError, match="device event queue diverged"):
        tsim.run_simulation(tc, base_params=jax_init(jc))
