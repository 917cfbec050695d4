"""The whole slice: the port's ``run_simulation`` against the JAX package's.

Both packages start from the JAX ``init_cnn(PRNGKey(seed))`` draw (carried
over with ``convert``) and the same seeded numpy task.  The port runs
``engine="masked", compute="block_skip"`` on the CPU (the kernel's plain
version); the reference runs its resident masked engine with
``compute="dense"``.  The bar is ROADMAP's parity contract: final_acc within
1e-3, identical prune_events, update_times exact, total_time within 1e-9,
global params within 1e-4.  One tiny run against the reference's own
block_skip (Pallas interpret mode) pins the FLOPs/blocks ledger exactly.
"""
import jax
import numpy as np
import pytest

from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import run_simulation as j_run
from repro.data.synthetic import SyntheticImageTask as JTask
from repro.models.cnn import init_cnn as j_init
from repro.models.cnn import vgg_config as j_vgg
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import run_simulation as t_run
from repro_torch.data.synthetic import SyntheticImageTask as TTask
from repro_torch.models.cnn import vgg_config as t_vgg

PLAN = [16, "M", 32]

CASES = {
    # Alg. 2 live: learning at round 2 prunes the slow workers in round 3
    "adaptcl_index": dict(method="adaptcl", importance="index"),
    "adaptcl_cig": dict(method="adaptcl", importance="cig_bnscalor"),
    "fedavg_s": dict(method="fedavg_s"),
    "fedavg": dict(method="fedavg"),
    # fixed rates, pruning mid-round (phase B trains the pruners' sub-stack)
    "fixed_rates_beta": dict(method="adaptcl", importance="no_adjacent", beta=0.5,
                             fixed_pruned_rates=[[0.0, 0.2, 0.4, 0.6], [0.1, 0.0, 0.3, 0.0]]),
    # non-IID shards and by-unit aggregation
    "by_unit_noniid": dict(method="adaptcl", importance="index", aggregation="by_unit",
                           noniid_s=80.0),
}


def _pair(case, seed=3, plan=PLAN, image=8, **over):
    kw = dict(rounds=4, prune_interval=2, num_workers=4, batch_size=8, local_epochs=1.0,
              eval_every=1, seed=seed)
    kw.update(CASES.get(case, {}))
    kw.update(over)
    jcfg = j_vgg("t", plan, num_classes=10, image_size=image)
    tcfg = t_vgg("t", plan, num_classes=10, image_size=image)
    task = dict(num_classes=10, image_size=image, train_size=96, test_size=64, seed=seed)
    base = {k: np.asarray(v) for k, v in j_init(jax.random.PRNGKey(seed), jcfg).items()}
    return kw, jcfg, tcfg, task, base


@pytest.fixture(scope="module")
def runs():
    """case -> (JAX masked dense result, port masked block_skip result),
    each pair run once per module."""
    cache = {}

    def get(case):
        if case not in cache:
            kw, jcfg, tcfg, task, base = _pair(case)
            rj = j_run(JSimConfig(engine="masked", compute="dense", cnn=jcfg,
                                  task=JTask(**task), **kw))
            rt = t_run(TSimConfig(engine="masked", compute="block_skip", cnn=tcfg,
                                  task=TTask(**task), device="cpu", **kw), base_params=base)
            cache[case] = (rj, rt)
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_prune_events_and_virtual_clock_identical(case, runs):
    rj, rt = runs(case)
    assert rt.prune_events == rj.prune_events
    if case.startswith("adaptcl") or case in ("fixed_rates_beta", "by_unit_noniid"):
        assert rt.prune_events, "the case must prune"
        assert min(rt.retentions) < 1.0
    assert rt.update_times == rj.update_times
    assert abs(rt.total_time - rj.total_time) <= 1e-9
    assert rt.retentions == rj.retentions
    assert rt.comm_bytes == rj.comm_bytes
    assert [t for t, _ in rt.acc_time] == [t for t, _ in rj.acc_time]
    assert rt.het_traj == rj.het_traj and rt.similarity_traj == rj.similarity_traj


@pytest.mark.parametrize("case", list(CASES))
def test_accuracy_and_global_params_within_contract(case, runs):
    rj, rt = runs(case)
    assert abs(rt.final_acc - rj.final_acc) <= 1e-3
    assert abs(rt.best_acc - rj.best_acc) <= 1e-3
    assert sorted(rt.global_params) == sorted(rj.global_params)
    for k in rj.global_params:
        np.testing.assert_allclose(rt.global_params[k], rj.global_params[k], atol=1e-4, err_msg=k)
    assert rt.param_reduction == pytest.approx(rj.param_reduction, abs=1e-12)
    assert rt.flops_reduction == pytest.approx(rj.flops_reduction, abs=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_counters_and_ideal_ledger_match(case, runs):
    """Same signatures, fleet calls and host dispatches as the reference's
    jit cache; zero extract/embed round-trips inside the loop."""
    rj, rt = runs(case)
    assert rt.recompiles == rj.recompiles
    assert rt.host_dispatches == rj.host_dispatches
    assert rt.batched_calls == rj.batched_calls
    assert rt.bucket_sizes == rj.bucket_sizes
    assert rt.host_roundtrips == rj.host_roundtrips == 0
    assert rt.flops_ideal == rj.flops_ideal
    assert rt.compute == "block_skip" and rt.device == "cpu"


def test_block_ledger_equals_jax_block_skip_exactly():
    """Against the reference's own block_skip (Pallas interpret mode): the
    FLOPs/blocks ledger is a host proxy and must match to the last FLOP."""
    plan = [32, "M", 64]
    kw, jcfg, tcfg, task, base = _pair(
        None, plan=plan, rounds=2, prune_interval=1, num_workers=2, eval_every=2,
        method="adaptcl", importance="index", fixed_pruned_rates=[[0.74, 0.74], [0.0, 0.0]],
        compute_blocks=(128, 8, 8),
    )
    task["train_size"] = 64
    rj = j_run(JSimConfig(engine="masked", compute="block_skip", cnn=jcfg, task=JTask(**task), **kw))
    rt = t_run(TSimConfig(engine="masked", compute="block_skip", cnn=tcfg, task=TTask(**task),
                          device="cpu", **kw), base_params=base)
    assert rt.prune_events == rj.prune_events and rt.prune_events
    assert rt.flops_executed == rj.flops_executed
    assert rt.blocks_executed == rj.blocks_executed
    assert rt.flops_ideal == rj.flops_ideal
    assert rt.flops_per_image_final == rj.flops_per_image_final
    assert rt.blocks_per_image_final == rj.blocks_per_image_final
    assert rt.blocks_executed > 0 and rt.flops_executed < rt.images_trained * 1e9
    assert abs(rt.final_acc - rj.final_acc) <= 1e-3
    for k in rj.global_params:
        np.testing.assert_allclose(rt.global_params[k], rj.global_params[k], atol=1e-4, err_msg=k)


def test_seeded_torch_init_runs_without_injected_params():
    kw, jcfg, tcfg, task, base = _pair("adaptcl_index", rounds=2)
    a = t_run(TSimConfig(engine="masked", compute="dense", cnn=tcfg, task=TTask(**task),
                         device="cpu", **kw))
    b = t_run(TSimConfig(engine="masked", compute="block_skip", cnn=tcfg, task=TTask(**task),
                         device="cpu", **kw))
    assert a.update_times == b.update_times and a.prune_events == b.prune_events
    for k in a.global_params:
        np.testing.assert_allclose(b.global_params[k], a.global_params[k], atol=1e-4, err_msg=k)
    assert np.isfinite(a.final_acc) and a.walltime_s > 0.0 and a.compile_walltime_s > 0.0


def test_run_sets_ieee_f32_flags_only_for_its_duration(monkeypatch):
    """TF32 off and deterministic cuDNN while a run lasts; the caller's own
    settings come back afterwards, also when the run raises."""
    import torch

    import repro_torch.core.simulation as tsim

    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    seen = []

    def probe(sim, env):
        seen.append(flags())
        raise RuntimeError("stop")

    monkeypatch.setattr(tsim, "_run_sync", probe)
    kw, jcfg, tcfg, task, base = _pair("fedavg", rounds=1)
    with pytest.raises(RuntimeError, match="stop"):
        t_run(TSimConfig(engine="masked", compute="block_skip", cnn=tcfg, task=TTask(**task),
                         device="cpu", **kw), base_params=base)
    assert seen == [(False, False, True)]
    assert flags() == (True, True, False)
