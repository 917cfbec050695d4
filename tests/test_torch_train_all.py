"""The port's masked ``FleetEngine.train_all`` against the JAX package's.

Twins of ``tests/test_fleet_equivalence.py``'s per-worker params and
single-program tests on the masked engine: every sub-model is embedded
into the base shape under its 0/1 masks, one stacked ``train_many`` call
trains each (shard, plan) bucket, and each worker's reconfigured view comes
back out.  Held within 1e-4 of JAX masked ``train_all`` and of the port's
own sequential engine, with the group-lasso factors taken from the
reconfigured shapes.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.fleet import FleetEngine as JFleet
from repro.core.fleet import FleetJob as JJob
from repro.core.masks import full_index, prune_to_budget
from repro.core.worker import LocalTrainer as JTrainer
from repro.core.worker import make_batch_plan
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy
from repro_torch.core.fleet import FleetEngine as TFleet
from repro_torch.core.fleet import FleetJob as TJob
from repro_torch.core.worker import LocalTrainer as TTrainer
from repro_torch.models import cnn as tcnn
from repro_torch.optim.group_lasso import group_size_sqrt

PLAN = [8, "M", 16]
ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (jcnn.vgg_config("vgg_tiny_eqv", PLAN, num_classes=4, image_size=8),
            tcnn.vgg_config("vgg_tiny_eqv", PLAN, num_classes=4, image_size=8))


@pytest.fixture(scope="module")
def fleet():
    """4 workers: two at full shape, two pruned to different sub-models
    (``tests/test_fleet_equivalence.py``'s fixture)."""
    jcfg, _ = _cfgs()
    params = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(0), jcfg).items()}
    space, unit_map = jcnn.build_unit_space(jcfg, params)
    shapes = {k: v.shape for k, v in params.items()}
    rng = np.random.default_rng(0)
    scores = {l.name: rng.normal(size=l.num_units) for l in space.layers}
    full = full_index(space)
    indices = [full, full, prune_to_budget(full, scores, 0.3, space),
               prune_to_budget(full, scores, 0.5, space)]
    subs = [jagg.extract_subparams(params, idx, unit_map) for idx in indices]
    xs = [rng.normal(size=(64, 8, 8, 3)).astype(np.float32) for _ in range(4)]
    ys = [rng.integers(0, 4, 64).astype(np.int32) for _ in range(4)]
    return unit_map, shapes, indices, subs, xs, ys


def _jobs(Job, fx, convert, sizes=(64, 64, 64, 64)):
    """The same plan stream for every engine; ``sizes`` are the images
    each worker's plan covers (unequal sizes: unequal plan shapes)."""
    _, _, indices, subs, xs, ys = fx
    rng = np.random.default_rng(7)
    return [Job(worker=w, params=convert(subs[w]), index=indices[w], x=xs[w], y=ys[w],
                plan=make_batch_plan(sizes[w], 16, 1.0, rng)) for w in range(4)]


def _port(engine, fx, lam, compute="dense", sizes=(64, 64, 64, 64)):
    unit_map, shapes = fx[0], fx[1]
    tr = TTrainer(_cfgs()[1], lr=0.05, compute=compute, device="cpu")
    fl = TFleet(tr, unit_map, shapes, "cpu", engine=engine)
    out = fl.train_all(_jobs(TJob, fx, params_from_numpy, sizes), lam)
    return [{k: v.numpy() for k, v in p.items()} for p in out], tr, fl


@pytest.fixture(scope="module")
def jax_masked(fleet):
    cache = {}

    def get(lam):
        if lam not in cache:
            unit_map, shapes = fleet[0], fleet[1]
            tr = JTrainer(_cfgs()[0], lr=0.05)
            fl = JFleet(tr, unit_map, shapes, engine="masked")
            out = fl.train_all(_jobs(JJob, fleet, dict), lam)
            cache[lam] = ([{k: np.asarray(v) for k, v in p.items()} for p in out],
                          tr.compile_count, fl.batched_calls)
        return cache[lam]

    return get


def _close(a, b, what):
    for w in range(len(b)):
        assert set(a[w]) == set(b[w])
        for k in b[w]:
            assert a[w][k].shape == b[w][k].shape, (what, w, k)
            np.testing.assert_allclose(a[w][k], b[w][k], atol=ATOL, err_msg=f"{what} worker {w} {k}")


@pytest.mark.parametrize("lam", [0.0, 1e-3, 1e-2])
def test_masked_train_all_matches_jax_masked_and_port_sequential(lam, fleet, jax_masked):
    ref, j_compiles, j_calls = jax_masked(lam)
    out, tr, fl = _port("masked", fleet, lam)
    _close(out, ref, "vs JAX masked")
    seq, _, _ = _port("sequential", fleet, lam)
    _close(out, seq, "vs port sequential")
    # one shard/plan shape: one stacked call, one signature, as in JAX
    assert fl.batched_calls == j_calls == 1
    assert tr.compile_count == j_compiles == 1 and tr.dispatch_count == 1


def test_masked_train_all_buckets_by_shard_and_plan_shape(fleet):
    """Unequal plans split the stack: one call per (shard, plan) shape,
    each bucket still matching the sequential engine."""
    sizes = (64, 32, 64, 32)
    out, tr, fl = _port("masked", fleet, 1e-3, sizes=sizes)
    seq, _, _ = _port("sequential", fleet, 1e-3, sizes=sizes)
    _close(out, seq, "bucketed plans")
    assert fl.batched_calls == 2 and tr.compile_count == 2


@pytest.mark.parametrize("lam", [0.0, 1e-2])
def test_group_lasso_factors_from_reconfigured_shapes(lam, fleet, monkeypatch):
    """train_all hands train_many each job's sqrt|g| of its reconfigured
    sub-model; with the base shapes' factors instead, lam 1e-2 lands away
    from the sequential engine."""
    seen = []
    orig = TTrainer.train_many

    def spy(self, *a, **kw):
        seen.append(kw["gl_sizes"])
        return orig(self, *a, **kw)

    monkeypatch.setattr(TTrainer, "train_many", spy)
    out, _, _ = _port("masked", fleet, lam)
    unit_map, _, _, subs, _, _ = fleet
    assert seen == [[group_size_sqrt(params_from_numpy(s), unit_map) for s in subs]]
    assert seen[0][3] != seen[0][0]           # the pruned worker's groups are smaller
    seq, _, _ = _port("sequential", fleet, lam)
    _close(out, seq, "vs port sequential")

    monkeypatch.setattr(TTrainer, "train_many",
                        lambda self, *a, **kw: orig(self, *a, **{**kw, "gl_sizes": None}))
    base_gl, _, _ = _port("masked", fleet, lam)
    gap = max(float(np.abs(base_gl[3][k] - seq[3][k]).max()) for k in seq[3])
    if lam == 0.0:
        assert gap <= ATOL
    else:
        assert gap > ATOL


def test_fused_engine_and_block_skip_fall_through_to_the_masked_path(fleet):
    """engine="fused" trains through the masked path, as in the reference;
    compute="block_skip" (the kernel's plain version on CPU tensors) agrees
    with the dense masked path."""
    dense, _, _ = _port("masked", fleet, 1e-3)
    fused, _, fl = _port("fused", fleet, 1e-3)
    _close(fused, dense, "fused vs masked")
    assert fl.batched_calls == 1
    skip, _, _ = _port("masked", fleet, 1e-3, compute="block_skip")
    _close(skip, dense, "block_skip vs dense")


def test_masked_train_all_skips_empty_plans(fleet):
    unit_map, shapes = fleet[0], fleet[1]
    tr = TTrainer(_cfgs()[1], lr=0.05, device="cpu")
    fl = TFleet(tr, unit_map, shapes, "cpu", engine="masked")
    jobs = _jobs(TJob, fleet, params_from_numpy)
    jobs[1].plan = jobs[1].plan[:0]
    out = fl.train_all(jobs, 0.0)
    assert out[1] is not jobs[1].params
    assert all(out[1][k] is jobs[1].params[k] for k in out[1])
    assert fl.batched_calls == 1 and tr.dispatch_count == 1
    seq = TFleet(TTrainer(_cfgs()[1], lr=0.05, device="cpu"), unit_map, shapes, "cpu",
                 engine="sequential").train_all(jobs, 0.0)
    _close([{k: v.numpy() for k, v in p.items()} for p in out],
           [{k: v.numpy() for k, v in p.items()} for p in seq], "empty plan")
