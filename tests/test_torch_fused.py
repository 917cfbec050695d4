"""The port's fused round engine (sync methods) against the JAX package.

Whole adaptcl / fedavg / fedavg_s runs at ``tests/test_fused.py``'s TINY
config (VGG [8, M, 16], 5 workers, 6 rounds, PI=2, the default task), both
packages from the JAX ``init_cnn`` draw, held under ROADMAP's parity
contract: identical ``prune_events`` (regrow events included) and
``scenario_rounds``, ``update_times`` at atol 0, ``total_time`` within
1e-9, equal ``host_dispatches``, ``fused_chunks``, ``recompiles``,
``comm_bytes`` and zero host round trips against JAX fused; final_acc
within 1e-3 and the global params within 1e-4 against JAX masked, or within
2x the envelope where that is larger (``torch_envelope``).  JAX fused is
not the params oracle: under AVX-512 its compiled chunk flips a ReLU gate
that JAX masked, JAX sequential and the port leave alone (ROADMAP queue C).
Cases: the plain run, a ``round_fusion`` cap that spans learning intervals,
phase B, by_unit, the static and the device-scored importance criteria,
sampling, dropout and churn, DGC, resident momentum (with churn),
regrowth, and the baselines.

Also: dispatches scale with chunks, not rounds; the padding and skipped
rounds the port does not run change no carried tensor (``RUN_DEAD_ROUNDS``
runs them as the reference's scan does, and every chunk's carry comes out
identical); and what stays refused on the fused engine, by field name.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch_envelope import assert_within_envelope, perturbations, ulp

from repro.core import scenario as jsc
from repro.core import simulation as jsim
from repro.core.timing import HeterogeneityConfig as JHet
from repro.data.synthetic import SyntheticImageTask as JTask
from repro.models import cnn as jcnn
from repro_torch.core import aggregation as tagg
from repro_torch.core import faults as tf
from repro_torch.core import fused as tfused
from repro_torch.core import scenario as tsc
from repro_torch.core import simulation as tsim
from repro_torch.core.fleet import masks_from_presence
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
W = 5
LEDGER_FIELDS = ("drift_events", "rounds_degraded", "rounds_skipped", "workers_recovered",
                 "retry_total", "byz_commits", "lost_commits", "dup_commits", "corrupt_commits",
                 "quarantined_commits")


SMALL = dict(num_classes=4, image_size=8, train_size=160, test_size=128, seed=5)


def configs(engine="fused", scen=None, regrow=None, task=None, **kw):
    """(JAX SimConfig, port SimConfig) of one run at test_fused.py's TINY
    config; ``scen`` is ScenarioConfig kwargs, ``regrow`` RegrowConfig's,
    ``task`` SyntheticImageTask's (default: the simulator's own task)."""
    base = dict(method="adaptcl", engine=engine, rounds=6, prune_interval=2, num_workers=W,
                batch_size=16, eval_every=2, seed=5)
    base.update(kw)
    if task is not None:
        jt, tt = JTask(**task), TTask(**task)
    else:
        jt = tt = None
    jc = jsim.SimConfig(cnn=jcnn.vgg_config("vgg_tiny_fused", PLAN, num_classes=4, image_size=8),
                        task=jt,
                        het=JHet(num_workers=W, sigma=3.0),
                        scenario=None if scen is None else jsc.ScenarioConfig(**scen),
                        regrow=None if regrow is None else jsim.RegrowConfig(**regrow), **base)
    tc = tsim.SimConfig(cnn=tcnn.vgg_config("vgg_tiny_fused", PLAN, num_classes=4, image_size=8),
                        task=tt,
                        het=THet(num_workers=W, sigma=3.0),
                        scenario=None if scen is None else tsc.ScenarioConfig(**scen),
                        regrow=None if regrow is None else tsim.RegrowConfig(**regrow),
                        device="cpu", **base)
    return jc, tc


_INIT = {}


def jax_init(jc):
    if jc.seed not in _INIT:
        _INIT[jc.seed] = {k: np.asarray(v) for k, v in
                          jcnn.init_cnn(jax.random.PRNGKey(jc.seed), jc.cnn).items()}
    return _INIT[jc.seed]


_PAIRS = {}


def pair(**kw):
    """(JAX fused, port fused) of one config, run once for the module."""
    key = repr(sorted(kw.items()))
    if key not in _PAIRS:
        jc, tc = configs(**kw)
        _PAIRS[key] = jsim.run_simulation(jc), tsim.run_simulation(tc, base_params=jax_init(jc))
    return _PAIRS[key]


def assert_events_and_counters(ref, port, events=None):
    """The exact part of the contract: events, clocks and ledgers against
    ``events`` (default ``ref``), the fused engine's counters against
    ``ref``."""
    events = ref if events is None else events
    assert port.prune_events == events.prune_events
    assert port.scenario_rounds == events.scenario_rounds
    np.testing.assert_allclose(np.array(port.update_times), np.array(events.update_times),
                               rtol=0, atol=0, equal_nan=True)
    assert abs(port.total_time - events.total_time) <= 1e-9
    assert [t for t, _ in port.acc_time] == [t for t, _ in events.acc_time]
    assert port.comm_bytes == events.comm_bytes
    assert port.retentions == events.retentions
    for f in LEDGER_FIELDS:
        assert getattr(port, f) == getattr(events, f), f
    assert port.host_dispatches == ref.host_dispatches
    assert port.fused_chunks == ref.fused_chunks > 0
    assert port.recompiles == ref.recompiles
    assert port.host_roundtrips == ref.host_roundtrips == 0
    assert port.engine == "fused"


# criteria that rank units by the trained params: their prune order, and
# the clocks and payloads that follow it, go with the params oracle
DATA_DEPENDENT = ("l1", "taylor")


def assert_contract(ref, port, what="", **kw):
    """Events and counters against JAX fused ``ref``; params and final_acc
    against JAX masked on the same config (``kw``), at 1e-4 / 1e-3 or 2x
    the envelope of the port's own runs: from the init one ulp up and down
    and in the other summation order.  Under a data-dependent
    criterion the prune order follows the trained params, so the events,
    clocks and payloads are held to JAX masked too."""
    jc, tc = configs(**kw)
    masked = jsim.run_simulation(dataclasses.replace(jc, engine="masked"))
    data_dependent = jc.importance in DATA_DEPENDENT
    assert_events_and_counters(ref, port, events=masked if data_dependent else ref)
    assert masked.prune_events == port.prune_events
    init = jax_init(jc)
    assert_within_envelope(
        port, masked, bar=1e-4, what=what,
        perturbed=perturbations(lambda b: tsim.run_simulation(tc, base_params=ulp(init, b))))


# ---------------------------------------------------------------------------
# whole runs against the JAX fused engine
# ---------------------------------------------------------------------------

CASES = {
    "plain": dict(),
    "fusion_cap": dict(rounds=7, prune_interval=3, round_fusion=2),
    "phase_b": dict(beta=0.5),
    "by_unit": dict(aggregation="by_unit"),
    "phase_b_by_unit": dict(beta=0.5, aggregation="by_unit", importance="l1"),
    "index": dict(importance="index"),
    "no_identical": dict(importance="no_identical"),
    "no_constant": dict(importance="no_constant"),
    "l1": dict(importance="l1"),
    "taylor": dict(importance="taylor"),
    "sampling": dict(scen=dict(participation=0.6, seed=1)),
    "dropout_churn": dict(scen=dict(participation=0.8, dropout=0.2, churn=0.15, seed=2)),
    "dgc": dict(dgc_sparsity=0.5),
    "momentum": dict(resident_momentum=True),
    "momentum_churn": dict(resident_momentum=True,
                           scen=dict(participation=0.8, dropout=0.1, churn=0.2, seed=4)),
    "fedavg": dict(method="fedavg", rounds=3),
    "fedavg_s": dict(method="fedavg_s", rounds=3, round_fusion=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_run_matches_jax_fused(case):
    ref, port = pair(**CASES[case])
    assert_contract(ref, port, case, **CASES[case])
    if case in ("plain", "phase_b", "by_unit", "l1", "taylor", "dgc", "momentum"):
        assert port.fused_chunks == 3 and len(port.prune_events) > 0
    if case == "fusion_cap":
        assert port.fused_chunks == 5          # 2+1 | 2+1 | 1
    if case == "dropout_churn":
        assert any(j > 0 for _, _, _, j in port.scenario_rounds)
    if case == "dgc":
        assert port.comm_bytes < pair()[1].comm_bytes


def test_fused_regrow_matches_jax_fused():
    """Regrow rounds (4, 7) cut chunks mid-interval; the host readjustment at
    the boundary adds one signature (the grow gradient) and its dispatches."""
    kw = dict(rounds=8, regrow=dict(interval=3, alpha0=0.3), round_fusion=4)
    ref, port = pair(**kw)
    assert_contract(ref, port, "regrow", **kw)
    assert {4, 7} <= {t for t, _, _ in port.prune_events}
    assert port.recompiles == 2


def test_fused_regrow_with_dgc_and_momentum():
    """Readjusted masks, device DGC and resident momentum at once.  At the
    TINY task (16 steps a round for 8 rounds) float32 training is chaotic
    here: the port lands 0.055 from JAX fused, and so does the port itself
    from the init moved one ulp up (then on JAX's accuracies).  So the
    events, clocks and counters are held exactly there, the params within
    2x the envelope, and the whole contract at the 160-image task, where
    training is not chaotic."""
    kw = dict(rounds=8, regrow=dict(interval=2, alpha0=0.4), dgc_sparsity=0.5,
              resident_momentum=True, round_fusion=4)
    ref, port = pair(**kw)
    assert_contract(ref, port, "regrow_dgc_momentum", **kw)
    ref, port = pair(task=SMALL, **kw)
    assert_contract(ref, port, "regrow_dgc_momentum_small", task=SMALL, **kw)


def test_fused_dispatches_scale_with_chunks_not_rounds():
    rounds, fusion = 8, 4
    jc, tc = configs(rounds=rounds, prune_interval=4, round_fusion=fusion, eval_every=rounds)
    fus = tsim.run_simulation(tc, base_params=jax_init(jc))
    mas = tsim.run_simulation(configs(engine="masked", rounds=rounds, prune_interval=4,
                                      eval_every=rounds)[1], base_params=jax_init(jc))
    eval_calls = 2 * 2       # the initial and final evals, two batches of 256 each
    assert fus.fused_chunks == rounds // fusion
    assert fus.host_dispatches == fus.fused_chunks + eval_calls
    assert (fus.host_dispatches - eval_calls) * 3 <= mas.host_dispatches - eval_calls
    assert fus.recompiles == 1 and fus.batched_calls == fus.fused_chunks
    assert fus.bucket_sizes == [W]
    # same events and clocks as the port's masked engine (float64 host
    # aggregation there, float32 on the device here)
    assert fus.prune_events == mas.prune_events
    np.testing.assert_allclose(np.array(fus.update_times), np.array(mas.update_times),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# dead rounds: not run here, run in full by the reference's scan
# ---------------------------------------------------------------------------

def _carries(monkeypatch, run_dead, tc, init):
    """Every chunk's carried state out of ``_SyncChunk`` (params as the next
    broadcast-back sees them: global * masks)."""
    out = []
    call = tfused._SyncChunk.__call__

    def spy(self, *args, **kw):
        res = call(self, *args, **kw)
        params, momentum, presence, global_p, dgc_res = res[:5]
        masks = masks_from_presence(presence, self.flat, self.unit_map, self.base_shapes)
        out.append({
            "global": {k: v.clone() for k, v in global_p.items()},
            "momentum": {k: v.clone() for k, v in momentum.items()},
            "dgc_res": {k: v.clone() for k, v in dgc_res.items()},
            "broadcast": {k: global_p[k].unsqueeze(0) * masks[k] for k in global_p},
            "presence": presence.clone(),
        })
        return res

    monkeypatch.setattr(tfused, "RUN_DEAD_ROUNDS", run_dead)
    monkeypatch.setattr(tfused._SyncChunk, "__call__", spy)
    res = tsim.run_simulation(tc, base_params=init)
    monkeypatch.setattr(tfused._SyncChunk, "__call__", call)
    return res, out


def test_dead_rounds_change_no_carried_tensor(monkeypatch):
    """Chunks padded to K_pad=4 (learning events cut them at 3 and 1
    rounds), a skipped outage round with a crash recovery inside a chunk,
    DGC residuals and resident momentum in the carry: running the dead
    rounds in full leaves every chunk's carry bit-identical."""
    jc, tc = configs(rounds=8, prune_interval=3, round_fusion=4, dgc_sparsity=0.5,
                     resident_momentum=True)
    fc = tf.FaultConfig(outage=tf.OutageConfig(start=2, length=1, slot_lo=0, slot_hi=3),
                        crash=tf.CrashConfig(rate=0.3, outage_rounds=1))
    tc.scenario = tsc.ScenarioConfig(seed=3, min_participants=4, faults=fc)
    init = jax_init(jc)
    a, ca = _carries(monkeypatch, False, tc, init)
    b, cb = _carries(monkeypatch, True, tc, init)
    assert a.rounds_skipped > 0 and a.workers_recovered > 0
    assert len(ca) == len(cb) == a.fused_chunks >= 3
    for x, y in zip(ca, cb):
        for part in ("global", "momentum", "dgc_res", "broadcast"):
            for k in x[part]:
                assert torch.equal(x[part][k], y[part][k]), (part, k)
        assert torch.equal(x["presence"], y["presence"])
    assert a.final_acc == b.final_acc and a.prune_events == b.prune_events
    np.testing.assert_array_equal(np.array(a.update_times), np.array(b.update_times))


# ---------------------------------------------------------------------------
# what stays refused on the fused engine
# ---------------------------------------------------------------------------

class _Mesh:
    """A mesh's shape alone: the guards fire before any collective."""

    def __init__(self, **shape):
        self.shape = shape


# the robust layer, the byzantine and channel families and the mesh run on
# the fused engine; the first four cases (their ids kept) are now the
# reference's own refusals with an async method: the trimmed mean, a mesh,
# byzantine and channel
@pytest.mark.parametrize("kw,field,why", [
    pytest.param(dict(method="fedasync_s", robust=tagg.RobustAggConfig(trim=0.2)),
                 r"RobustAggConfig\.trim=0\.2", "clip + quarantine only", id="kw0-robust-A9"),
    pytest.param(dict(method="fedasync_s", mesh=_Mesh(fleet=2)), r"SimConfig\.mesh",
                 "requires the fused SYNC engine", id="kw1-mesh-A10"),
    pytest.param(dict(method="fedasync_s", scenario=tsc.ScenarioConfig(faults=tf.FaultConfig(
        byzantine=tf.ByzantineConfig(workers=(0,))))), "byzantine fault family",
        "byzantine is sync-only", id="kw2-scenario\\.faults\\.byzantine-A9"),
    pytest.param(dict(method="fedasync_s", scenario=tsc.ScenarioConfig(faults=tf.FaultConfig(
        channel=tf.ChannelConfig(drop=0.1)))), "channel fault family",
        "channel is sync-only", id="kw3-scenario\\.faults\\.channel-A9"),
    (dict(compute="block_skip"), "compute", "compute='dense' only"),
    (dict(importance="hrank"), "importance", "host-side statistics"),
    (dict(importance="fpgm"), "importance", "host-side statistics"),
    (dict(method="fedasync_s", resident_momentum=True), "resident_momentum", "async"),
])
def test_fused_refusals_by_field_name(kw, field, why):
    sim = tsim.SimConfig(engine="fused", rounds=1, num_workers=2, device="cpu", **kw)
    with pytest.raises(ValueError, match=field) as err:
        tsim.run_simulation(sim)
    assert why in str(err.value)


@pytest.mark.parametrize("method", ["adaptcl", "dcasgd_s"])
def test_fused_runs_on_the_card_unless_the_cpu_is_asked(method):
    """``SimConfig.device`` defaults to the card on the fused engine too,
    and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' legitimately runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.run_simulation(tsim.SimConfig(method=method, engine="fused", rounds=1,
                                           num_workers=2))
    res = tsim.run_simulation(tsim.SimConfig(method=method, engine="fused", rounds=1,
                                             num_workers=2, device="cpu"))
    assert res.device == "cpu" and res.fused_chunks == 1
