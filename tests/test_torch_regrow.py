"""FedDST mask regrowth on the port against the JAX package.

Host pieces exactly: ``flatten_unit_space``, ``presence_from_index`` /
``index_from_presence``, ``grow_order`` and ``regrow_index`` on seeded scores
with ties, ``grad_magnitude_scores``, ``_weight_magnitude_scores`` and the
anneal ``_regrow_alpha``; ``RegrowConfig``'s validations; and
``_regrow_step`` of both packages on one shared global and index (the grow
signal is each package's own float32 gradient, ranked in float64): identical
new indices.  Then whole adaptcl runs with regrowth on the port's
``sequential`` and ``masked`` engines (dense, and block_skip: the kernel's
plain version on the CPU) against the JAX ``sequential`` and ``masked``
engines (ROADMAP's oracle for regrowth; the JAX fused engine disagrees with
them, queue C): identical prune events, regrow events included, and the
parity contract.  A run whose readjustment never fires is bit-identical to
one without regrowth.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import importance as jimp
from repro.core import masks as jmasks
from repro.core import simulation as jsim
from repro.core.timing import HeterogeneityConfig as JHet
from repro.data.synthetic import SyntheticImageTask as JTask
from repro.models import cnn as jcnn
from repro_torch.core import importance as timp
from repro_torch.core import masks as tmasks
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


PLAN = [8, "M", 16]
SEED = 5
W = 4
TASK = dict(num_classes=4, image_size=8, train_size=160, test_size=128, seed=SEED)
RATES = [[0.0, 0.2, 0.3, 0.4], [0.0, 0.1, 0.2, 0.3]]


def cnns():
    return (jcnn.vgg_config("tiny_regrow", PLAN, num_classes=4, image_size=8),
            tcnn.vgg_config("tiny_regrow", PLAN, num_classes=4, image_size=8))


def space_pair():
    """The same unit space in both packages (a VGG with two prunable
    layers), and the JAX init it was built from."""
    jcfg, tcfg = cnns()
    init = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(SEED), jcfg).items()}
    jspace, jmap = jcnn.build_unit_space(jcfg, init)
    tspace, tmap = tcnn.build_unit_space(tcfg, {k: torch.tensor(v) for k, v in init.items()})
    return (jspace, jmap), (tspace, tmap), init


def configs(engine, compute="dense", **kw):
    base = dict(method="adaptcl", engine=engine, rounds=6, num_workers=W, batch_size=16,
                eval_every=2, seed=SEED, prune_interval=2, fixed_pruned_rates=RATES)
    base.update(kw)
    jcfg, tcfg = cnns()
    jreg = base.pop("regrow", dict(interval=2, alpha0=0.3))
    jc = jsim.SimConfig(cnn=jcfg, het=JHet(num_workers=W, sigma=3.0), task=JTask(**TASK),
                        regrow=None if jreg is None else jsim.RegrowConfig(**jreg), **base)
    tc = tsim.SimConfig(cnn=tcfg, het=THet(num_workers=W, sigma=3.0), task=TTask(**TASK),
                        regrow=None if jreg is None else tsim.RegrowConfig(**jreg),
                        device="cpu", compute=compute, compute_blocks=(8, 8, 8), **base)
    return jc, tc


def jax_init(jc):
    return {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(SEED), jc.cnn).items()}


@pytest.fixture(scope="module")
def cache():
    store = {}

    def get(key, fn, *args, **kw):
        if key not in store:
            store[key] = fn(*args, **kw)
        return store[key]

    return get


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

def test_flatten_unit_space_equal():
    (jspace, _), (tspace, _), _ = space_pair()
    a, b = jmasks.flatten_unit_space(jspace), tmasks.flatten_unit_space(tspace)
    assert a.names == b.names and a.fixed_params == b.fixed_params
    for f in ("sizes", "offsets", "layer_of", "unit_id", "costs", "min_units", "tiebreak"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


def test_presence_roundtrip_equal():
    (jspace, _), (tspace, _), _ = space_pair()
    rng = np.random.default_rng(0)
    idx = {l.name: np.sort(rng.choice(l.num_units, size=max(1, l.num_units // 2), replace=False))
           for l in tspace.layers}
    fa, fb = jmasks.flatten_unit_space(jspace), tmasks.flatten_unit_space(tspace)
    pa, pb = jmasks.presence_from_index(idx, fa), tmasks.presence_from_index(idx, fb)
    assert pa.dtype == pb.dtype and np.array_equal(pa, pb)
    back = tmasks.index_from_presence(pb, fb)
    assert all(np.array_equal(back[k], idx[k]) for k in idx)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("budget", [0, 1, 150, 400, 10**6])
def test_grow_order_and_regrow_index_equal(budget, ties):
    """Seeded scores (with ``ties``, rounded so many collide) on a half
    index: identical grow orders and regrown indices."""
    (jspace, _), (tspace, _), _ = space_pair()
    rng = np.random.default_rng(budget + 7 * ties)
    scores = {l.name: rng.random(l.num_units) for l in tspace.layers}
    if ties:
        scores = {k: np.round(v, 1) for k, v in scores.items()}
    idx = {l.name: np.sort(rng.choice(l.num_units, size=max(1, l.num_units // 2), replace=False))
           for l in tspace.layers}
    fa, fb = jmasks.flatten_unit_space(jspace), tmasks.flatten_unit_space(tspace)
    assert np.array_equal(jmasks.grow_order(scores, fa), tmasks.grow_order(scores, fb))
    a = jmasks.regrow_index(idx, scores, budget, jspace)
    b = tmasks.regrow_index(idx, scores, budget, tspace)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    added = sum((len(b[l.name]) - len(idx[l.name])) * l.unit_param_cost for l in tspace.layers)
    max_cost = max(l.unit_param_cost for l in tspace.layers)
    if 0 < budget <= 400:
        assert budget <= added < budget + max_cost     # overshoot under one unit cost


def test_grad_and_weight_magnitude_scores_equal():
    (jspace, jmap), (tspace, tmap), init = space_pair()
    rng = np.random.default_rng(3)
    grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in init.items()}
    a = jimp.grad_magnitude_scores(grads, jmap, jspace.unit_counts)
    b = timp.grad_magnitude_scores(grads, tmap, tspace.unit_counts)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert all(v.dtype == np.float64 for v in b.values())
    a = jsim._weight_magnitude_scores(init, jmap, jspace.unit_counts)
    b = tsim._weight_magnitude_scores(init, tmap, tspace.unit_counts)
    assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_regrow_alpha_and_rounds_equal(schedule):
    jc, tc = configs("sequential", regrow=dict(interval=3, alpha0=0.4, schedule=schedule))
    for t in range(1, 13):
        assert tsim._regrow_alpha(tc.regrow, t, 12) == jsim._regrow_alpha(jc.regrow, t, 12)
        assert tsim._regrow_round(tc, t) == jsim._regrow_round(jc, t)


@pytest.mark.parametrize("kw", [dict(interval=0), dict(alpha0=0.0), dict(alpha0=1.0),
                                dict(schedule="linear")])
def test_regrow_config_validations_raise_alike(kw):
    with pytest.raises(ValueError) as ja:
        jsim.RegrowConfig(**kw)
    with pytest.raises(ValueError) as tb:
        tsim.RegrowConfig(**kw)
    assert str(ja.value) == str(tb.value)


def test_regrow_step_identical_indices_on_one_global():
    """Both packages' ``_regrow_step`` on the JAX init as the global and the
    same pruned indices: identical readjusted workers and indices, and the
    port's ``env.rng`` left untouched."""
    jc, tc = configs("sequential")
    init = jax_init(jc)
    jenv, tenv = jsim._Env(jc), tsim._Env(tc, base_params=init)
    rng = np.random.default_rng(9)
    idx = [jmasks.full_index(jenv.space)]
    for keep in (0.75, 0.5, 0.6):
        idx.append({l.name: np.sort(rng.choice(l.num_units, size=max(1, int(l.num_units * keep)),
                                               replace=False))
                    for l in jenv.space.layers})
    ji = [{k: v.copy() for k, v in i.items()} for i in idx]
    ti = [{k: v.copy() for k, v in i.items()} for i in idx]
    state = tenv.rng.bit_generator.state
    a = jsim._regrow_step(jc, jenv, init, ji, 3)
    b = tsim._regrow_step(tc, tenv, tenv.base_params, ti, 3)
    assert tenv.rng.bit_generator.state == state
    assert [w for w, _ in a] == [w for w, _ in b] == [1, 2, 3]
    for (_, x), (_, y) in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    for w in (1, 2, 3):
        assert any(not np.array_equal(ti[w][k], idx[w][k]) for k in idx[w]), "must readjust"


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

def assert_contract(rj, rt):
    assert rt.prune_events == rj.prune_events
    np.testing.assert_allclose(np.array(rt.update_times), np.array(rj.update_times),
                               rtol=0, atol=0)
    assert abs(rt.total_time - rj.total_time) <= 1e-9
    assert [t for t, _ in rt.acc_time] == [t for t, _ in rj.acc_time]
    assert rt.retentions == rj.retentions and rt.comm_bytes == rj.comm_bytes
    assert abs(rt.final_acc - rj.final_acc) <= 1e-3
    for k in rj.global_params:
        np.testing.assert_allclose(rt.global_params[k], rj.global_params[k], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("importance", ["cig_bnscalor", "index"])
@pytest.mark.parametrize("engine,compute,oracle", [("sequential", "dense", "sequential"),
                                                   ("masked", "dense", "masked"),
                                                   ("masked", "block_skip", "masked")])
def test_regrow_run_matches_jax(engine, compute, oracle, importance, cache):
    jc, tc = configs(engine, compute, importance=importance)
    jc.engine = oracle
    rj = cache(("jax", oracle, importance), jsim.run_simulation, jc)
    rt = tsim.run_simulation(tc, base_params=jax_init(jc))
    assert_contract(rj, rt)
    # rounds 3 and 5 start a readjustment; round 5's regrows the pruned rows
    regrows = [e for e in rt.prune_events if e[0] == 5][:3]
    assert [w for _, w, _ in regrows] == [1, 2, 3]
    assert rt.host_roundtrips == rj.host_roundtrips
    if engine == "masked":
        assert rt.host_roundtrips == 0


def test_regrow_that_never_fires_is_bit_identical():
    _, off = configs("masked", "block_skip", regrow=None)
    _, late = configs("masked", "block_skip", regrow=dict(interval=50))
    a, b = tsim.run_simulation(off), tsim.run_simulation(late)
    assert a.prune_events == b.prune_events and a.total_time == b.total_time
    assert a.acc_time == b.acc_time
    assert all(np.array_equal(a.global_params[k], b.global_params[k]) for k in a.global_params)


def test_regrow_readds_the_removed_mass():
    """Each readjustment keeps retention within one unit cost of where it
    was, and revives at least one unit the worker had pruned."""
    jc, tc = configs("masked", "block_skip")
    r = tsim.run_simulation(tc, base_params=jax_init(jc))
    env = tsim._Env(tc)
    cost = max(l.unit_param_cost for l in env.space.layers)
    last = {w: None for w in range(W)}
    revived = 0
    for t, w, idx in r.prune_events:
        idx = {k: np.asarray(v) for k, v in idx.items()}
        prev = last[w]
        if prev is not None and t == 5 and prev[0] < 5:
            before = sum(len(prev[1][l.name]) * l.unit_param_cost for l in env.space.layers)
            after = sum(len(idx[l.name]) * l.unit_param_cost for l in env.space.layers)
            assert before <= after < before + cost
            revived += sum(len(np.setdiff1d(idx[k], prev[1][k])) for k in idx)
        last[w] = (t, idx)
    assert revived > 0
