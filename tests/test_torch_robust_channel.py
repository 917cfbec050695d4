"""The lossy-channel world, whole runs on the port against the JAX package.

At ``tests/test_robust.py``'s own config (TINY VGG, 5 workers, 8 rounds,
PI=2, seed 5) under DEFENSE (clip 5, trim 0.2, quarantine with probation
100), CHAN: drop 0.2 (retries stretch the clock and re-send uploads), dup
0.2 (a duplicate weighs twice in the mean and once in the trim), corrupt
0.1 with std 10 (the reference's Threefry noise on the payload).

* Each of the port's ``sequential``, ``bucketed``, ``masked``
  (``compute="block_skip"``) and ``fused`` engines meets the reference's
  ``_assert_engines_match`` against the JAX engine of the same name, params
  within 1e-3, both packages from the JAX ``init_cnn`` draw one ulp down.
  From the draw itself this world and the byzantine noise-mode world are a
  float32 coin: 16 SGD steps a round for 8 rounds amplify a reordered sum,
  and the reference's own bucketed and sequential engines part there by
  1e-2 in params (the witness is ``tests/test_torch_robust_chaos.py``; the
  noise-mode world from the draw one ulp down is
  ``tests/test_torch_robust_noise.py``).
* From the draw itself, in both worlds, the port's ``masked`` and
  ``fused`` engines meet the contract against their JAX namesakes.
"""
import jax
import numpy as np
import pytest
import torch

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
JCFG = jcnn.vgg_config("vgg_tiny_rb", PLAN, num_classes=4, image_size=8)
INIT = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(5), JCFG).items()}
DOWN = {k: np.nextafter(v, np.float32(-np.inf)) for k, v in INIT.items()}


def world(pkg, name):
    f, s, a = (jf, jsc, jagg) if pkg == "jax" else (tf, tsc, tagg)
    fam = {
        "chan": dict(channel=f.ChannelConfig(drop=0.2, dup=0.2, corrupt=0.1, corrupt_std=10.0)),
        "noise": dict(byzantine=f.ByzantineConfig(workers=(0, 1), mode="noise", noise_std=1.0)),
    }[name]
    return dict(scenario=s.ScenarioConfig(faults=f.FaultConfig(**fam)),
                robust=a.RobustAggConfig(clip=5.0, trim=0.2,
                                         quarantine=a.QuarantineConfig(probation=100)))


def _base(engine):
    return dict(method="adaptcl", engine=engine, rounds=8, prune_interval=2, num_workers=5,
                batch_size=16, eval_every=2, seed=5)


def jax_run(engine, name, init=None):
    """The reference; ``init`` replaces its ``init_cnn`` draw."""
    draw = jsim.init_cnn
    if init is not None:
        jsim.init_cnn = lambda k, c: init
    try:
        return jsim.run_simulation(jsim.SimConfig(
            cnn=JCFG, het=JHet(num_workers=5, sigma=3.0), **world("jax", name),
            **_base(engine)))
    finally:
        jsim.init_cnn = draw


def port_run(engine, name, init=INIT):
    extra = dict(compute="block_skip") if engine == "masked" else {}
    return tsim.run_simulation(tsim.SimConfig(
        cnn=tcnn.vgg_config("vgg_tiny_rb", PLAN, num_classes=4, image_size=8),
        het=THet(num_workers=5, sigma=3.0), device="cpu", **world("port", name),
        **_base(engine), **extra), base_params=init)


def maxdiff(a, b):
    return max(float(np.max(np.abs(np.asarray(a.global_params[k], np.float32)
                                   - np.asarray(b.global_params[k], np.float32))))
               for k in a.global_params)


def assert_engines_match(ref, other):
    assert abs(ref.final_acc - other.final_acc) <= 1e-3
    assert ref.prune_events == other.prune_events
    assert ref.scenario_rounds == other.scenario_rounds
    np.testing.assert_allclose(np.array(ref.update_times), np.array(other.update_times),
                               rtol=0, atol=0, equal_nan=True)
    assert ref.total_time == pytest.approx(other.total_time, abs=1e-9)
    assert ref.comm_bytes == pytest.approx(other.comm_bytes, abs=1e-6)
    for f in LEDGER_FIELDS:
        assert getattr(ref, f) == getattr(other, f), f


def check_world(name, engine, init):
    """The port's ``engine`` against JAX's in world ``name``, both from
    ``init`` (None: the JAX draw itself)."""
    ref = jax_run(engine, name, init=init)
    port = port_run(engine, name, init=INIT if init is None else init)
    assert_engines_match(ref, port)
    assert maxdiff(ref, port) <= 1e-3
    if name == "chan":
        assert port.retry_total > 0 and port.dup_commits > 0 and port.corrupt_commits > 0
        assert port.lost_commits > 0
    else:
        assert port.byz_commits > 0 and port.quarantined_commits > 0


@pytest.mark.parametrize("engine", ["sequential", "bucketed", "masked", "fused"])
def test_channel_world_matches_the_same_jax_engine(engine):
    check_world("chan", engine, DOWN)


@pytest.mark.parametrize("engine", ["masked", "fused"])
@pytest.mark.parametrize("name", ["chan", "noise"])
def test_resident_engines_match_jax_from_the_draw(name, engine):
    check_world(name, engine, None)
