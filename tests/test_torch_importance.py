"""The data-dependent importances (l1, taylor, fpgm, hrank) of the port
against the JAX package's.

Each criterion as a function on the same context; ``LocalTrainer.gradient``
and ``local_unit_stats`` on the same sub-model and shard (VGG, a bottleneck
ResNet and a basic-block ResNet, pruned and unpruned) within 1e-5 relative;
then one whole masked-engine run per criterion at a small ResNet under
ROADMAP's parity contract, with ``recompiles``, ``host_dispatches`` and
``host_roundtrips`` equal to the reference's (the resident engine extracts
each pruning worker's row once, at its scoring boundary).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import importance as jimp
from repro.core.aggregation import extract_subparams
from repro.core.masks import full_index, prune_to_budget
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import run_simulation as j_run
from repro.core.worker import LocalTrainer as JTrainer
from repro.core.worker import local_unit_stats as j_stats
from repro.data.synthetic import SyntheticImageTask as JTask
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy
from repro_torch.core import importance as timp
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import run_simulation as t_run
from repro_torch.core.worker import LocalTrainer as TTrainer
from repro_torch.core.worker import local_unit_stats as t_stats
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


CRITERIA = ["l1", "taylor", "fpgm", "hrank"]


@pytest.mark.parametrize("method", CRITERIA)
def test_criterion_equals_jax_on_the_same_context(method):
    rng = np.random.default_rng(len(method))
    counts = {"a": 12, "b": 7}
    sig = lambda: {k: np.where(rng.random(n) < 0.2, -np.inf, rng.random(n)) for k, n in counts.items()}
    fields = dict(weight_norms=sig(), grads=sig(), activations=sig())
    a = jimp.METHODS[method](jimp.ImportanceContext(unit_counts=counts, worker=2, round=1, seed=4, **fields))
    b = timp.METHODS[method](timp.ImportanceContext(unit_counts=counts, worker=2, round=1, seed=4, **fields))
    assert list(a) == list(b)
    for k in a:
        assert b[k].dtype == np.float64
        np.testing.assert_array_equal(b[k], a[k])
    with pytest.raises(ValueError, match=method):
        timp.METHODS[method](timp.ImportanceContext(unit_counts=counts))


NETS = {
    "vgg": lambda m: m.vgg_config("t", [8, "M", 16, 16], num_classes=10, image_size=8),
    "bottleneck": lambda m: m.resnet_config("t", 8, [(1, 8), (1, 16)], num_classes=10, image_size=8),
    "basic": lambda m: m.resnet_config("t", 8, [(1, 8), (2, 16)], num_classes=10, image_size=8,
                                       bottleneck=False),
}


def _rel(a, b):
    fin = np.isfinite(a)
    assert (fin == np.isfinite(b)).all()
    return float(np.abs(a[fin] - b[fin]).max() / np.abs(a[fin]).max())


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("net", list(NETS))
def test_local_unit_stats_match_jax(net, rate):
    """The same (trained-looking) sub-model and shard through both
    packages: gradient, group norms, |g.w| and activations within 1e-5
    relative per layer, -inf exactly on the absent units."""
    jcfg, tcfg = NETS[net](jcnn), NETS[net](tcnn)
    rng = np.random.default_rng(3)
    base = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(1), jcfg).items()}
    for k in base:   # move BN off its init so every signal is non-trivial
        if "/bn_" in k:
            base[k] = base[k] + rng.normal(scale=0.3, size=base[k].shape).astype(np.float32)
    space, unit_map = jcnn.build_unit_space(jcfg, base)
    scores = {l.name: rng.random(l.num_units) for l in space.layers}
    index = prune_to_budget(full_index(space), scores, rate, space)
    sub = extract_subparams(base, index, unit_map)
    x = rng.normal(size=(70, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 70).astype(np.int32)
    jt, tt = JTrainer(jcfg), TTrainer(tcfg, device="cpu")
    gj = jt.gradient(sub, unit_map, x[:64], y[:64])
    gt = tt.gradient(params_from_numpy(sub), unit_map, x[:64], y[:64])
    for k in gj:
        np.testing.assert_allclose(gt[k].numpy(), gj[k], atol=1e-6, rtol=1e-4, err_msg=k)
    sj = j_stats(jt, sub, index, space, unit_map, x, y)
    st = t_stats(tt, params_from_numpy(sub), index, space, unit_map, x, y)
    assert sorted(sj) == sorted(st)
    for kind in sj:
        assert sorted(sj[kind]) == sorted(st[kind]) == sorted(l.name for l in space.layers)
        for lname in sj[kind]:
            assert st[kind][lname].dtype == np.float64
            assert _rel(sj[kind][lname], st[kind][lname]) <= 1e-5, (kind, lname)
            assert np.isneginf(st[kind][lname]).sum() == space.unit_counts[lname] - len(index[lname])
    # one counted gradient call per stats call, keyed by the sub-model's shapes
    assert (tt.compile_count, tt.dispatch_count) == (jt.compile_count, jt.dispatch_count) == (1, 2)


def _run_pair(method):
    args = ("t", 8, [(1, 8), (1, 16)])
    jcfg = jcnn.resnet_config(*args, num_classes=10, image_size=8)
    tcfg = tcnn.resnet_config(*args, num_classes=10, image_size=8)
    seed = 3
    # learning at round 2 prunes in round 3
    kw = dict(rounds=3, prune_interval=2, num_workers=4, batch_size=8, local_epochs=1.0,
              eval_every=1, seed=seed, method="adaptcl", importance=method, engine="masked")
    task = dict(num_classes=10, image_size=8, train_size=96, test_size=64, seed=seed)
    base = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg).items()}
    rj = j_run(JSimConfig(compute="dense", cnn=jcfg, task=JTask(**task), **kw))
    rt = t_run(TSimConfig(compute="block_skip", cnn=tcfg, task=TTask(**task), device="cpu", **kw),
               base_params=base)
    return rj, rt


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(method):
        if method not in cache:
            cache[method] = _run_pair(method)
        return cache[method]

    return get


@pytest.mark.parametrize("method", CRITERIA)
def test_masked_run_within_contract(method, runs):
    """Port block_skip (plain kernel) against the reference's masked dense
    engine: identical prune events and clocks, accuracy and params."""
    rj, rt = runs(method)
    assert rt.prune_events == rj.prune_events and rt.prune_events
    assert min(rt.retentions) < 1.0
    assert rt.update_times == rj.update_times
    assert abs(rt.total_time - rj.total_time) <= 1e-9
    assert abs(rt.final_acc - rj.final_acc) <= 1e-3
    for k in rj.global_params:
        np.testing.assert_allclose(rt.global_params[k], rj.global_params[k], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("method", CRITERIA)
def test_masked_run_counters_equal_jax(method, runs):
    """One row extraction per pruning worker (a host round trip) and one
    gradient signature per distinct sub-model shape, as in the reference."""
    rj, rt = runs(method)
    pruners = len(rt.prune_events)
    assert rt.host_roundtrips == rj.host_roundtrips == pruners
    assert rt.recompiles == rj.recompiles
    assert rt.host_dispatches == rj.host_dispatches
    assert rt.batched_calls == rj.batched_calls
    assert rt.bucket_sizes == rj.bucket_sizes
