"""The byzantine world, the inert robust config and the async robust layer,
whole runs on the port against the JAX package.

At ``tests/test_robust.py``'s own config (TINY VGG, 5 workers, 8 rounds,
PI=2, seed 5, the default task), both packages from the JAX ``init_cnn``
draw:

* the BYZ world (workers 0 and 1 send ``-10 x`` their deltas) under
  DEFENSE (clip 5, trim 0.2, quarantine with probation 100): each of the
  port's ``sequential``, ``bucketed``, ``masked`` (``compute="block_skip"``,
  the plain kernel on the CPU) and ``fused`` engines meets the reference's
  ``_assert_engines_match`` against the JAX engine of the same name
  (identical prune events, scenario rounds and fault ledger with
  ``quarantined_commits``, update times at atol 0, total time within 1e-9,
  comm bytes within 1e-6), with final_acc within 1e-3 and global params
  within 1e-4 of JAX masked, or within 2x the envelope where that is
  larger (``torch_envelope``: the port's own runs from the init one ulp up
  and down and in the other summation order; on an AVX2 CPU the port's
  masked and fused engines land 1.2e-2 from JAX masked here and move
  3.4e-2 and 2.6e-2 within their envelope);
* ``FaultConfig()`` with ``RobustAggConfig()`` is bit-identical to a run
  with neither (the reference's ``:227``);
* fedasync_s with clip 0.5 and a hair-trigger quarantine on the port's
  ``masked`` and ``fused`` engines: exact ``quarantined_commits`` (> 0) and
  clocks against the JAX engine of the same name, final_acc within the
  reference's own 0.01.

The channel and noise-mode worlds are in ``tests/test_torch_robust_channel.py``.
"""
import jax
import numpy as np
import pytest
import torch
from torch_envelope import assert_within_envelope, perturbations, ulp

from repro.core import aggregation as jagg
from repro.core import faults as jf
from repro.core import scenario as jsc
from repro.core import simulation as jsim
from repro.core.timing import HeterogeneityConfig as JHet
from repro.models import cnn as jcnn
from repro_torch.core import aggregation as tagg
from repro_torch.core import faults as tf
from repro_torch.core import scenario as tsc
from repro_torch.core import simulation as tsim
from repro_torch.core.timing import HeterogeneityConfig as THet
from repro_torch.models import cnn as tcnn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PLAN = [8, "M", 16]
LEDGER_FIELDS = ("drift_events", "rounds_degraded", "rounds_skipped", "workers_recovered",
                 "retry_total", "byz_commits", "lost_commits", "dup_commits", "corrupt_commits",
                 "quarantined_commits")
INIT = {k: np.asarray(v) for k, v in jcnn.init_cnn(
    jax.random.PRNGKey(5), jcnn.vgg_config("vgg_tiny_rb", PLAN, num_classes=4, image_size=8)
).items()}


def _pkg(pkg):
    return (jf, jsc, jagg, jsim, jcnn, JHet) if pkg == "jax" else (tf, tsc, tagg, tsim, tcnn, THet)


def world(pkg, name):
    """``scenario`` and ``robust`` of a named world in ``pkg``: BYZ, CHAN
    and DEFENSE are ``tests/test_robust.py``'s."""
    f, s, a = _pkg(pkg)[:3]
    fam = {
        "byz": dict(byzantine=f.ByzantineConfig(workers=(0, 1), mode="scale", scale=-10.0)),
        "inert": {},
    }[name]
    robust = (a.RobustAggConfig() if name == "inert" else
              a.RobustAggConfig(clip=5.0, trim=0.2,
                                quarantine=a.QuarantineConfig(probation=100)))
    return dict(scenario=s.ScenarioConfig(faults=f.FaultConfig(**fam)), robust=robust)


def run(pkg, engine, init=INIT, **kw):
    f, s, a, sim, cnn, het = _pkg(pkg)
    base = dict(method="adaptcl", engine=engine, rounds=8, prune_interval=2, num_workers=5,
                batch_size=16, eval_every=2, seed=5,
                cnn=cnn.vgg_config("vgg_tiny_rb", PLAN, num_classes=4, image_size=8),
                het=het(num_workers=5, sigma=3.0))
    base.update(kw)
    if pkg == "jax":
        return sim.run_simulation(sim.SimConfig(**base))
    if engine == "masked":
        base.setdefault("compute", "block_skip")
    return sim.run_simulation(sim.SimConfig(device="cpu", **base), base_params=init)


def ledger(r):
    return {f: getattr(r, f) for f in LEDGER_FIELDS}


def assert_engines_match(ref, other):
    """``tests/test_robust.py``'s ``_assert_engines_match`` but final_acc
    (held under ``torch_envelope``): events, clocks, comm bytes, ledger."""
    assert ref.prune_events == other.prune_events
    assert ref.scenario_rounds == other.scenario_rounds
    np.testing.assert_allclose(np.array(ref.update_times), np.array(other.update_times),
                               rtol=0, atol=0, equal_nan=True)
    assert ref.total_time == pytest.approx(other.total_time, abs=1e-9)
    assert ref.comm_bytes == pytest.approx(other.comm_bytes, abs=1e-6)
    assert ledger(ref) == ledger(other)


_JAX_BYZ = {}


def jax_byz(engine):
    """The reference's BYZ world on ``engine``, run once for the module."""
    if engine not in _JAX_BYZ:
        _JAX_BYZ[engine] = run("jax", engine, **world("jax", "byz"))
    return _JAX_BYZ[engine]


@pytest.mark.parametrize("engine", ["sequential", "bucketed", "masked", "fused"])
def test_byzantine_world_matches_the_same_jax_engine(engine):
    ref = jax_byz(engine)
    port = run("port", engine, **world("port", "byz"))
    assert_engines_match(ref, port)
    assert_within_envelope(port, jax_byz("masked"), bar=1e-4, what=f"byz/{engine}",
                           perturbed=perturbations(lambda b: run(
                               "port", engine, init=ulp(INIT, b), **world("port", "byz"))))
    assert port.byz_commits > 0 and port.quarantined_commits > 0
    assert port.prune_events


def test_inactive_robust_config_bit_identical_to_none():
    """``faults=FaultConfig()`` + ``RobustAggConfig()`` consume no draw and
    take the plain aggregation, byte for byte."""
    ref = run("port", "masked", rounds=4)
    inert = run("port", "masked", rounds=4, **world("port", "inert"))
    assert inert.final_acc == ref.final_acc
    assert inert.prune_events == ref.prune_events
    assert inert.total_time == ref.total_time
    assert inert.update_times == ref.update_times
    for k in ref.global_params:
        assert np.array_equal(ref.global_params[k], inert.global_params[k])
    assert ledger(ref) == ledger(inert) == {f: 0 for f in LEDGER_FIELDS}


def _async_robust(pkg):
    a = _pkg(pkg)[2]
    return a.RobustAggConfig(clip=0.5, quarantine=a.QuarantineConfig(
        threshold=1.0, strikes=1, probation=2))


@pytest.mark.parametrize("engine", ["masked", "fused"])
def test_async_clip_quarantine_matches_the_same_jax_engine(engine):
    ref = run("jax", engine, method="fedasync_s", robust=_async_robust("jax"))
    port = run("port", engine, method="fedasync_s", robust=_async_robust("port"),
               compute="dense")
    assert port.quarantined_commits == ref.quarantined_commits > 0
    assert port.total_time == pytest.approx(ref.total_time, abs=1e-9)
    assert [t for t, _ in port.acc_time] == [t for t, _ in ref.acc_time]
    assert abs(port.final_acc - ref.final_acc) <= 0.01
    assert ledger(port) == ledger(ref)
