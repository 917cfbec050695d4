"""The port's reconfiguring engines (``sequential``, ``bucketed``) against
the JAX package's.

Host pieces first: ``embed_params``, ``coordinate_mask``, the float64
per-worker ``aggregate_by_worker`` / ``aggregate_by_unit`` and
``reslice_subparams`` equal the reference's.  Then per-worker params at the
fleet level: the port's sequential, bucketed and masked engines against the
reference's sequential ``FleetEngine.train_all`` (mirroring
``tests/test_fleet_equivalence.py``).  Then whole ``run_simulation`` runs of
each engine against the reference's same engine under ROADMAP's parity
contract, with equal counters (signatures, dispatches, stacked calls,
buckets, host round trips).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import worker as jworker
from repro.core.fleet import FleetEngine as JFleet
from repro.core.fleet import FleetJob as JJob
from repro.core.masks import full_index, prune_to_budget
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import run_simulation as j_run
from repro.core.worker import LocalTrainer as JTrainer
from repro.data.synthetic import SyntheticImageTask as JTask
from repro.models import cnn as jcnn
from repro_torch.convert import params_from_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core import worker as tworker
from repro_torch.core.fleet import FleetEngine as TFleet
from repro_torch.core.fleet import FleetJob as TJob
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import run_simulation as t_run
from repro_torch.core.worker import LocalTrainer as TTrainer
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


TINY_PLAN = [8, "M", 16]


def _tiny():
    return (jcnn.vgg_config("vgg_tiny_eqv", TINY_PLAN, num_classes=4, image_size=8),
            tcnn.vgg_config("vgg_tiny_eqv", TINY_PLAN, num_classes=4, image_size=8))


def _fleet_fixture():
    """4 workers: two at full shape, two pruned to different sub-models."""
    jcfg, _ = _tiny()
    params = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(0), jcfg).items()}
    space, unit_map = jcnn.build_unit_space(jcfg, params)
    base_shapes = {k: v.shape for k, v in params.items()}
    rng = np.random.default_rng(0)
    scores = {l.name: rng.normal(size=l.num_units) for l in space.layers}
    full = full_index(space)
    indices = [full, full, prune_to_budget(full, scores, 0.3, space),
               prune_to_budget(full, scores, 0.5, space)]
    worker_params = [jagg.extract_subparams(params, idx, unit_map) for idx in indices]
    xs = [rng.normal(size=(64, 8, 8, 3)).astype(np.float32) for _ in range(4)]
    ys = [rng.integers(0, 4, 64).astype(np.int32) for _ in range(4)]
    return params, space, unit_map, base_shapes, indices, worker_params, xs, ys


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

def test_embed_mask_and_list_aggregation_match_jax():
    params, space, unit_map, shapes, indices, subs, _, _ = _fleet_fixture()
    rng = np.random.default_rng(1)
    subs = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in s.items()} for s in subs]
    for s, idx in zip(subs, indices):
        ej = jagg.embed_params(s, idx, unit_map, shapes)
        et = tagg.embed_params(params_from_numpy(s), idx, unit_map, shapes)
        for k in ej:
            np.testing.assert_array_equal(et[k].numpy(), ej[k])
            np.testing.assert_array_equal(tagg.coordinate_mask(k, idx, unit_map, shapes),
                                          jagg.coordinate_mask(k, idx, unit_map, shapes))
    jsub = list(zip(subs, indices))
    tsub = [(params_from_numpy(s), idx) for s, idx in zip(subs, indices)]
    for jf, tf in ((jagg.aggregate_by_worker, tagg.aggregate_by_worker),
                   (jagg.aggregate_by_unit, tagg.aggregate_by_unit)):
        a, b = jf(jsub, unit_map, shapes), tf(tsub, unit_map, shapes)
        for k in a:
            assert b[k].dtype == torch.float64
            np.testing.assert_allclose(b[k].numpy(), a[k], rtol=1e-15, atol=1e-15, err_msg=k)


def test_embed_and_extract_tally_round_trips():
    params, _, unit_map, shapes, indices, subs, _, _ = _fleet_fixture()
    before = tagg.roundtrip_total()
    sub = tagg.extract_subparams(params_from_numpy(params), indices[3], unit_map)
    tagg.embed_params(sub, indices[3], unit_map, shapes)
    assert tagg.roundtrip_total() - before == 2
    with pytest.raises(ValueError, match="units along axis"):
        tagg.embed_params(params_from_numpy(subs[3]), indices[2], unit_map, shapes)


def test_reslice_and_prune_and_reconfigure_match_jax():
    params, space, unit_map, _, indices, subs, _, _ = _fleet_fixture()
    rng = np.random.default_rng(2)
    scores = {l.name: rng.normal(size=l.num_units) for l in space.layers}
    pj, ij = JTrainer(_tiny()[0]).prune_and_reconfigure(subs[2], indices[2], scores, 0.3, space, unit_map)
    pt, it = TTrainer(_tiny()[1], device="cpu").prune_and_reconfigure(
        params_from_numpy(subs[2]), indices[2], scores, 0.3, space, unit_map)
    assert {k: v.tolist() for k, v in ij.items()} == {k: v.tolist() for k, v in it.items()}
    for k in pj:
        np.testing.assert_array_equal(pt[k].numpy(), pj[k])
    rt = tworker.reslice_subparams(params_from_numpy(params), indices[0], indices[3], unit_map)
    rj = jworker.reslice_subparams(params, indices[0], indices[3], unit_map)
    for k in rj:
        np.testing.assert_array_equal(rt[k].numpy(), rj[k])


# ---------------------------------------------------------------------------
# per-worker params at the fleet level
# ---------------------------------------------------------------------------

def _jobs(Job, worker_params, indices, xs, ys, convert):
    rng = np.random.default_rng(7)     # the same plan stream for every engine
    return [Job(worker=w, params=convert(worker_params[w]), index=indices[w], x=xs[w], y=ys[w],
                plan=jworker.make_batch_plan(64, 16, 1.0, rng)) for w in range(4)]


@pytest.fixture(scope="module")
def jax_sequential():
    """lam -> the reference's sequential per-worker params and signatures."""
    cache = {}

    def get(lam):
        if lam not in cache:
            _, _, unit_map, shapes, indices, subs, xs, ys = _fleet_fixture()
            tr = JTrainer(_tiny()[0], lr=0.05)
            fleet = JFleet(tr, unit_map, shapes, engine="sequential")
            out = fleet.train_all(_jobs(JJob, subs, indices, xs, ys, dict), lam)
            cache[lam] = ([{k: np.asarray(v) for k, v in p.items()} for p in out], tr.compile_count)
        return cache[lam]

    return get


@pytest.mark.parametrize("lam", [0.0, 1e-3, 1e-2])
@pytest.mark.parametrize("engine", ["sequential", "bucketed"])
def test_per_worker_params_match_jax_sequential(engine, lam, jax_sequential):
    ref, _ = jax_sequential(lam)
    _, _, unit_map, shapes, indices, subs, xs, ys = _fleet_fixture()
    tr = TTrainer(_tiny()[1], lr=0.05, device="cpu")
    fleet = TFleet(tr, unit_map, shapes, "cpu", engine=engine)
    out = fleet.train_all(_jobs(TJob, subs, indices, xs, ys, params_from_numpy), lam)
    for w in range(4):
        for k in ref[w]:
            np.testing.assert_allclose(out[w][k].numpy(), ref[w][k], atol=1e-4,
                                       err_msg=f"{engine} worker {w} {k}")
    # 3 distinct sub-model shapes: 3 stacked calls, one signature each
    assert tr.compile_count == 3
    assert fleet.batched_calls == (3 if engine == "bucketed" else 0)
    assert tr.dispatch_count == (3 if engine == "bucketed" else 4)


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_masked_engine_rows_match_sequential(lam):
    """The port's resident masked engine, trained from the embedded
    sub-models on the same plans, gives each worker's reconfigured params
    (extracted from its row) within 1e-4 of its own sequential engine."""
    params, space, unit_map, shapes, indices, subs, xs, ys = _fleet_fixture()
    tr = TTrainer(_tiny()[1], lr=0.05, device="cpu")
    seq = TFleet(tr, unit_map, shapes, "cpu", engine="sequential").train_all(
        _jobs(TJob, subs, indices, xs, ys, params_from_numpy), lam)
    masked = TFleet(tr, unit_map, shapes, "cpu", engine="masked")
    state = masked.init_state(params_from_numpy(params), xs, ys)
    masked.refresh_masks(state, indices)
    plans = [j.plan for j in _jobs(TJob, subs, indices, xs, ys, dict)]
    for w in range(4):
        emb = tagg.embed_params(params_from_numpy(subs[w]), indices[w], unit_map, shapes)
        for k in state.params:
            state.params[k][w] = emb[k]
    masked.train_rounds(state, plans, lam)
    for w in range(4):
        row = tagg.extract_subparams({k: v[w] for k, v in state.params.items()}, indices[w], unit_map)
        for k in row:
            np.testing.assert_allclose(row[k].numpy(), seq[w][k].numpy(), atol=1e-4,
                                       err_msg=f"worker {w} {k}")
    # the masked engine's train_all (embed, one stacked masked call, extract)
    out = masked.train_all(_jobs(TJob, subs, indices, xs, ys, params_from_numpy), lam)
    for w in range(4):
        for k in out[w]:
            np.testing.assert_allclose(out[w][k].numpy(), seq[w][k].numpy(), atol=1e-4,
                                       err_msg=f"train_all worker {w} {k}")


# ---------------------------------------------------------------------------
# whole simulations, engine against engine
# ---------------------------------------------------------------------------

CASES = {
    "adaptcl_index": ("vgg", dict(method="adaptcl", importance="index")),
    # fixed rates pruning mid-round, by-unit aggregation, non-IID shards
    "fixed_beta_by_unit": ("vgg", dict(method="adaptcl", importance="no_adjacent", beta=0.5,
                                       aggregation="by_unit", noniid_s=80.0,
                                       fixed_pruned_rates=[[0.0, 0.2, 0.4, 0.6], [0.1, 0.0, 0.3, 0.0]])),
    "resnet_cig": ("resnet", dict(method="adaptcl", importance="cig_bnscalor")),
    "resnet_taylor": ("resnet", dict(method="adaptcl", importance="taylor")),
    # the unpruned baseline: full-shape workers, no prune event
    "fedavg_s": ("vgg", dict(method="fedavg_s")),
}


def _cfgs(kind):
    if kind == "vgg":
        return (jcnn.vgg_config("t", [16, "M", 32], num_classes=10, image_size=8),
                tcnn.vgg_config("t", [16, "M", 32], num_classes=10, image_size=8))
    args = ("t", 8, [(1, 8), (1, 16)])
    return (jcnn.resnet_config(*args, num_classes=10, image_size=8),
            tcnn.resnet_config(*args, num_classes=10, image_size=8))


@pytest.fixture(scope="module")
def runs():
    """(case, engine) -> (JAX result, port result) on the same engine."""
    cache = {}

    def get(case, engine):
        if (case, engine) not in cache:
            kind, over = CASES[case]
            jcfg, tcfg = _cfgs(kind)
            seed = 3
            kw = dict(rounds=4, prune_interval=2, num_workers=4, batch_size=8, local_epochs=1.0,
                      eval_every=1, seed=seed, engine=engine, **over)
            task = dict(num_classes=10, image_size=8, train_size=96, test_size=64, seed=seed)
            base = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg).items()}
            rj = j_run(JSimConfig(cnn=jcfg, task=JTask(**task), **kw))
            rt = t_run(TSimConfig(cnn=tcfg, task=TTask(**task), device="cpu", **kw), base_params=base)
            cache[(case, engine)] = (rj, rt)
        return cache[(case, engine)]

    return get


ENGINE_CASES = [(c, e) for c in CASES for e in ("sequential", "bucketed")]


@pytest.mark.parametrize("case,engine", ENGINE_CASES)
def test_engine_prune_events_and_clock_identical(case, engine, runs):
    rj, rt = runs(case, engine)
    assert rt.engine == rj.engine == engine
    assert rt.prune_events == rj.prune_events
    if CASES[case][1]["method"] == "adaptcl":
        assert rt.prune_events and min(rt.retentions) < 1.0
    else:
        assert not rt.prune_events and rt.retentions == [1.0] * 4
    assert rt.update_times == rj.update_times
    assert abs(rt.total_time - rj.total_time) <= 1e-9
    assert rt.retentions == rj.retentions
    assert rt.comm_bytes == rj.comm_bytes
    assert rt.het_traj == rj.het_traj and rt.similarity_traj == rj.similarity_traj


@pytest.mark.parametrize("case,engine", ENGINE_CASES)
def test_engine_accuracy_and_params_within_contract(case, engine, runs):
    rj, rt = runs(case, engine)
    assert abs(rt.final_acc - rj.final_acc) <= 1e-3
    assert abs(rt.best_acc - rj.best_acc) <= 1e-3
    for k in rj.global_params:
        np.testing.assert_allclose(rt.global_params[k], rj.global_params[k], atol=1e-4, err_msg=k)
    assert rt.param_reduction == pytest.approx(rj.param_reduction, abs=1e-12)
    assert rt.flops_reduction == pytest.approx(rj.flops_reduction, abs=1e-12)


@pytest.mark.parametrize("case,engine", ENGINE_CASES)
def test_engine_counters_and_ledger_match(case, engine, runs):
    rj, rt = runs(case, engine)
    assert rt.recompiles == rj.recompiles
    assert rt.host_dispatches == rj.host_dispatches
    assert rt.batched_calls == rj.batched_calls
    assert rt.bucket_sizes == rj.bucket_sizes
    assert rt.host_roundtrips == rj.host_roundtrips > 0
    # reconfigured models execute exactly their size
    assert rt.flops_executed == rj.flops_executed == rt.flops_ideal == rj.flops_ideal


def test_engines_agree_with_each_other_in_the_port(runs):
    """Sequential, bucketed and the resident masked engine: one run."""
    _, seq = runs("resnet_cig", "sequential")
    _, buck = runs("resnet_cig", "bucketed")
    kind, over = CASES["resnet_cig"]
    _, tcfg = _cfgs(kind)
    base = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(3), _cfgs(kind)[0]).items()}
    masked = t_run(TSimConfig(
        cnn=tcfg, task=TTask(num_classes=10, image_size=8, train_size=96, test_size=64, seed=3),
        device="cpu", engine="masked", rounds=4, prune_interval=2, num_workers=4, batch_size=8,
        local_epochs=1.0, eval_every=1, seed=3, **over), base_params=base)
    for alt in (buck, masked):
        assert alt.prune_events == seq.prune_events and alt.update_times == seq.update_times
        assert abs(alt.final_acc - seq.final_acc) <= 1e-3
        for k in seq.global_params:
            np.testing.assert_allclose(alt.global_params[k], seq.global_params[k], atol=1e-4, err_msg=k)
    assert masked.host_roundtrips == 0 and seq.host_roundtrips > 0
