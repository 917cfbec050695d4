"""The port's mesh-sharded fleet (``SimConfig.mesh`` on the fused sync
engine, over ``torch.distributed``) against the JAX mesh.

At ``tests/test_sharded_fleet.py``'s TINY config (VGG [8, M, 16], W=8, 6
rounds, PI=2, seed 5), both packages from the JAX ``init_cnn`` draw.  The
port's ranks are gloo processes on the CPU (``launch.mesh.spawn_ranks``),
each holding ``W / n`` rows; every world size is spawned once for the whole
module, its cases run in one job while the JAX references are computed.

* the index algebra (``global_to_shard_local``, ``shard_cohorts``,
  ``bucket_rows(multiple=)``, out-of-range slots) against the reference's
  functions on the same inputs;
* ``all_gather_fleet``, ``shard_row_slice`` and ``psum_fleet`` at world
  sizes 1, 2 and 4 against numpy, and the two-tier by-worker and by-unit
  aggregations against the single-stack functions; at world size 1 bit for
  bit;
* world size 1: bit-identical to the port's no-mesh fused engine (plain
  and the robust world of ``tests/test_robust.py``), the contract against
  JAX ``make_fleet_mesh(1)``, and the three ``SimResult`` mesh fields;
* 2 and 4 ranks against JAX ``make_fleet_mesh(2)`` / ``(4)`` under
  ROADMAP's parity contract (identical prune events and scenario rounds,
  update times exact, total time within 1e-9, equal counters), with params
  within 1e-4 and final_acc within 1e-3 of JAX masked (JAX's fused chunk,
  which the JAX mesh runs, flips a ReLU gate the other engines leave alone
  on some CPUs: ROADMAP queue C), or within 2x the envelope where that is
  larger (``torch_envelope``: the port's no-mesh fused run from the init
  one ulp up and down and in the other summation order): plain at both sizes, l1 and by_unit at 2, taylor and DGC with
  regrow at 4; every rank's result bit-identical; ``host_dispatches`` and
  ``fused_chunks`` equal to the no-mesh run's;
* the scenario world (sampling, dropout, churn) at 4 ranks against JAX
  fused without a mesh, that test's own oracle: the JAX mesh stops there
  on a churn join (``repro/core/fleet.py:484`` writes a fleet-sharded row
  outside a mesh context under this JAX version).  In this world JAX fused
  parts from its own masked and sequential engines (params 1e-3 apart
  after 6 rounds, 9e-6 after 2), while those two, and the port's fused,
  masked and sequential engines, agree within 4e-7, and a one-ulp change
  of the init moves the port's run by 4e-7 (a ReLU gate the compiled
  chunk flips: ROADMAP queue C).  So the port is held to JAX fused in
  everything but the params and final_acc, and to JAX masked in those as
  every case is;
* the robust world (BYZ under DEFENSE) at 4 ranks against JAX
  ``make_fleet_mesh(4)`` and JAX masked, the same way;
* the guards: a fleet that does not divide over the mesh, a mesh without
  its fleet axis, more ranks than the group, no group, a rank that fails
  (the job raises its traceback), and a one-rank NCCL group on the card
  (``cuda``).
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch
from torch_envelope import assert_within_envelope, perturbations, ulp

from repro.core import aggregation as jagg
from repro.core import faults as jf
from repro.core import fleet as jfleet
from repro.core import scenario as jsc
from repro.core import simulation as jsim
from repro.core.timing import HeterogeneityConfig as JHet
from repro.launch.mesh import make_fleet_mesh as j_fleet_mesh
from repro.models import cnn as jcnn
from repro_torch.core import aggregation as tagg
from repro_torch.core import faults as tf
from repro_torch.core import fleet as tfleet
from repro_torch.core import scenario as tsc
from repro_torch.core import simulation as tsim
from repro_torch.core.timing import HeterogeneityConfig as THet
from repro_torch.launch import mesh as tmesh
from repro_torch.models import cnn as tcnn
from repro_torch.sharding import collectives as tcoll


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_rank():
    """A one-rank gloo group in this process, destroyed after the test."""
    with tmesh.fleet_group(device="cpu"):
        yield tmesh.make_fleet_mesh(1)


PLAN = [8, "M", 16]
W = 8
LEDGER_FIELDS = ("drift_events", "rounds_degraded", "rounds_skipped", "workers_recovered",
                 "retry_total", "byz_commits", "lost_commits", "dup_commits", "corrupt_commits",
                 "quarantined_commits")

# (world, kwargs) of each case; a world is None, "scenario" or "robust"
CASES = {
    "plain": (None, {}),
    "l1": (None, dict(importance="l1")),
    "taylor": (None, dict(importance="taylor")),
    "by_unit": (None, dict(aggregation="by_unit")),
    "dgc_regrow": (None, dict(dgc_sparsity=0.5, regrow=(2, 0.3), eval_every=6)),
    "scenario": ("scenario", {}),
    "robust": ("robust", {}),
}
AT = {2: ("plain", "l1", "by_unit"), 4: ("plain", "taylor", "dgc_regrow", "scenario", "robust")}


def configs(case):
    """(JAX SimConfig, port SimConfig) of a case, without a mesh."""
    world, kw = CASES[case]
    kw = dict(kw)
    base = dict(method="adaptcl", engine="fused", rounds=6, prune_interval=2, num_workers=W,
                batch_size=16, eval_every=2, seed=5)
    regrow = kw.pop("regrow", None)
    base.update(kw)
    j_extra, t_extra = {}, {}
    if regrow is not None:
        j_extra["regrow"] = jsim.RegrowConfig(interval=regrow[0], alpha0=regrow[1])
        t_extra["regrow"] = tsim.RegrowConfig(interval=regrow[0], alpha0=regrow[1])
    if world == "scenario":
        scen = dict(participation=0.8, dropout=0.2, churn=0.15, seed=2)
        j_extra["scenario"] = jsc.ScenarioConfig(**scen)
        t_extra["scenario"] = tsc.ScenarioConfig(**scen)
    if world == "robust":
        byz = dict(workers=(0, 1), mode="scale", scale=-10.0)
        j_extra["scenario"] = jsc.ScenarioConfig(faults=jf.FaultConfig(
            byzantine=jf.ByzantineConfig(**byz)))
        t_extra["scenario"] = tsc.ScenarioConfig(faults=tf.FaultConfig(
            byzantine=tf.ByzantineConfig(**byz)))
        j_extra["robust"] = jagg.RobustAggConfig(clip=5.0, trim=0.2,
                                                 quarantine=jagg.QuarantineConfig(probation=100))
        t_extra["robust"] = tagg.RobustAggConfig(clip=5.0, trim=0.2,
                                                 quarantine=tagg.QuarantineConfig(probation=100))
    name = "vgg_tiny_rb" if world == "robust" else "vgg_tiny_fused"
    jc = jsim.SimConfig(cnn=jcnn.vgg_config(name, PLAN, num_classes=4, image_size=8),
                        het=JHet(num_workers=W, sigma=3.0), **j_extra, **base)
    tc = tsim.SimConfig(cnn=tcnn.vgg_config(name, PLAN, num_classes=4, image_size=8),
                        het=THet(num_workers=W, sigma=3.0), device="cpu", **t_extra, **base)
    return jc, tc


_INIT = {}


def jax_init():
    if not _INIT:
        jc, _ = configs("plain")
        _INIT.update({k: np.asarray(v) for k, v in
                      jcnn.init_cnn(jax.random.PRNGKey(jc.seed), jc.cnn).items()})
    return _INIT


def collective_inputs():
    """The stacks of the reference's two-tier test (``:232-279``)."""
    rng = np.random.default_rng(7)
    stacks = {"a": rng.normal(size=(W, 3, 2)).astype(np.float32),
              "b": rng.normal(size=(W, 5)).astype(np.float32)}
    masks = {k: (rng.random(v.shape) > 0.3).astype(np.float32) for k, v in stacks.items()}
    weights = rng.random(W).astype(np.float32)
    submitters = (rng.random(W) > 0.2).astype(np.float32)
    return stacks, masks, weights, submitters


@pytest.fixture(scope="module")
def fleet():
    """Each world size's job (every case of ``AT`` plus the collectives) on
    spawned gloo ranks, and the JAX references computed meanwhile:
    ``{"port": {n: [per-rank outputs]}, "jax": {(n, case): SimResult}}``
    (n = 0 for JAX fused without a mesh)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    init = jax_init()
    jobs = {}
    try:
        for n, cases in AT.items():
            todo = [(c, "simulate", (configs(c)[1], init)) for c in cases]
            todo.append(("collectives", "collectives", collective_inputs()))
            jobs[n] = tmesh.spawn_ranks(n, tmesh.run_cases, (todo,))
        refs = {(1, "plain"): jsim.run_simulation(
            dataclasses.replace(configs("plain")[0], mesh=j_fleet_mesh(1)))}
        for n, cases in AT.items():
            for c in cases:
                jc = configs(c)[0]
                if c == "scenario":     # the JAX mesh cannot churn: its own oracle
                    refs[(0, c)] = jsim.run_simulation(jc)
                    refs[(0, "scenario_masked")] = jsim.run_simulation(
                        dataclasses.replace(jc, engine="masked"))
                else:
                    refs[(n, c)] = jsim.run_simulation(
                        dataclasses.replace(jc, mesh=j_fleet_mesh(n)))
                    if ("masked", c) not in refs:
                        refs[("masked", c)] = jsim.run_simulation(
                            dataclasses.replace(jc, engine="masked"))
        port = {n: job.join() for n, job in jobs.items()}
    finally:
        for job in jobs.values():
            job.close()
    return {"port": port, "jax": refs}


def port_fused(case):
    return tsim.run_simulation(configs(case)[1], base_params=jax_init())


def assert_events(ref, port):
    """The exact part of the contract: events, clocks, ledger (params and
    final_acc are held under ``torch_envelope``)."""
    assert port.prune_events == ref.prune_events
    assert port.scenario_rounds == ref.scenario_rounds
    np.testing.assert_allclose(np.array(port.update_times), np.array(ref.update_times),
                               rtol=0, atol=0, equal_nan=True)
    assert abs(port.total_time - ref.total_time) <= 1e-9
    assert [t for t, _ in port.acc_time] == [t for t, _ in ref.acc_time]
    assert port.comm_bytes == ref.comm_bytes
    assert port.retentions == ref.retentions
    for f in LEDGER_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f


def assert_counters(ref, port):
    assert port.host_dispatches == ref.host_dispatches
    assert port.fused_chunks == ref.fused_chunks > 0
    assert port.recompiles == ref.recompiles
    assert port.host_roundtrips == ref.host_roundtrips == 0


def assert_bit_identical(a, b):
    assert a.prune_events == b.prune_events and a.scenario_rounds == b.scenario_rounds
    np.testing.assert_array_equal(np.array(a.update_times), np.array(b.update_times))
    assert a.acc_time == b.acc_time and a.total_time == b.total_time
    assert a.retentions == b.retentions and a.comm_bytes == b.comm_bytes
    for f in LEDGER_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    for k in a.global_params:
        assert np.array_equal(a.global_params[k], b.global_params[k]), k


# ---------------------------------------------------------------------------
# the index algebra, against the reference's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,nw,ns", [
    ([0, 3, 4, 7], 8, 2), ([5, 2], 8, 1), ([7, 0, 6, 1, 2], 8, 4), ([], 8, 4),
    ([8], 8, 2), ([-1], 8, 2), ([0], 6, 4),
])
def test_global_to_shard_local_and_shard_cohorts_match_the_reference(rows, nw, ns):
    try:
        want = jfleet.global_to_shard_local(rows, nw, ns)
    except ValueError as err:
        match = "outside" if "outside" in str(err) else "divide"
        with pytest.raises(ValueError, match=match):
            tfleet.global_to_shard_local(rows, nw, ns)
        with pytest.raises(ValueError, match=match):
            tsc.shard_cohorts(rows, nw, ns)
        return
    got = tfleet.global_to_shard_local(rows, nw, ns)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    parts, ref = tsc.shard_cohorts(rows, nw, ns), jsc.shard_cohorts(rows, nw, ns)
    assert len(parts) == len(ref) == ns
    for a, b in zip(parts, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int64


@pytest.mark.parametrize("n,cap,multiple", [
    (3, 8, 1), (2, 8, 8), (5, 8, 4), (5, 12, 3), (1, 8, 2), (9, 16, 4), (9, 10, 4), (0, 8, 1),
    (3, 8, 0),
])
def test_bucket_rows_multiple_matches_the_reference(n, cap, multiple):
    try:
        want = jfleet.bucket_rows(n, cap, multiple=multiple)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err).split()[0]):
            tfleet.bucket_rows(n, cap, multiple=multiple)
        return
    assert tfleet.bucket_rows(n, cap, multiple=multiple) == want
    if multiple == 1:
        assert tfleet.bucket_rows(n, cap) == want


def test_gather_scatter_reject_out_of_range_rows():
    stacks = {"w": torch.arange(12.0).reshape(4, 3)}
    sub = tfleet.gather_stack_rows(stacks, np.array([2, 0]), num_rows=4)
    np.testing.assert_array_equal(sub["w"].numpy(), [[6, 7, 8], [0, 1, 2]])
    with pytest.raises(ValueError, match="outside"):
        tfleet.gather_stack_rows(stacks, np.array([4]), num_rows=4)
    with pytest.raises(ValueError, match="outside"):
        tfleet.scatter_stack_rows(stacks, np.array([-1]), sub, num_rows=4)


# ---------------------------------------------------------------------------
# collectives and two-tier aggregation
# ---------------------------------------------------------------------------

def _single_stack(stacks, masks, weights, submitters):
    t = {k: torch.as_tensor(v) for k, v in stacks.items()}
    return (tagg.aggregate_by_worker_stacked_dev(t, torch.as_tensor(weights)),
            tagg.aggregate_by_unit_stacked_dev(t, {k: torch.as_tensor(v) for k, v in masks.items()},
                                               torch.as_tensor(submitters)))


def _check_collectives(outs, n):
    stacks, masks, weights, submitters = collective_inputs()
    by_w, by_u = _single_stack(stacks, masks, weights, submitters)
    wl = W // n
    for r, out in enumerate(outs):
        for k, v in stacks.items():
            np.testing.assert_array_equal(out["gathered"][k], v)
            np.testing.assert_array_equal(out["gathered_dim1"][k], np.moveaxis(v, 0, 1))
            np.testing.assert_allclose(out["psum"][k], v.sum(axis=0), rtol=0, atol=1e-6)
            np.testing.assert_allclose(out["by_worker"][k], by_w[k].numpy(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(out["by_unit"][k], by_u[k].numpy(), rtol=0, atol=1e-6)
            for part in ("psum", "by_worker", "by_unit"):      # replicated, bit for bit
                np.testing.assert_array_equal(out[part][k], outs[0][part][k])
        np.testing.assert_array_equal(out["row_slice"], weights[r * wl : (r + 1) * wl])
    return by_w, by_u


def test_collectives_at_one_rank_are_the_no_mesh_values(one_rank):
    out = tmesh.collectives(one_rank, *collective_inputs())
    by_w, by_u = _check_collectives([out], 1)
    stacks = collective_inputs()[0]
    for k in stacks:
        assert np.array_equal(out["by_worker"][k], by_w[k].numpy())
        assert np.array_equal(out["by_unit"][k], by_u[k].numpy())
        assert np.array_equal(out["psum"][k], torch.as_tensor(stacks[k]).sum(dim=0).numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_and_two_tier_aggregation(fleet, n):
    outs = [o["collectives"] for o in fleet["port"][n]]
    _check_collectives(outs, n)
    # one backend collective per call: 2 gathers, 1 psum, 1 by-worker, 1 by-unit
    assert fleet["port"][n][0]["_calls"]["collectives"]["all_gather"] == 5


# ---------------------------------------------------------------------------
# world size 1
# ---------------------------------------------------------------------------

def test_one_rank_mesh_is_the_no_mesh_engine(one_rank, fleet):
    ref = port_fused("plain")
    one = tsim.run_simulation(dataclasses.replace(configs("plain")[1], mesh=one_rank),
                              base_params=jax_init())
    assert_bit_identical(ref, one)
    assert one.host_dispatches == ref.host_dispatches and one.fused_chunks == ref.fused_chunks
    assert (one.n_devices, one.fleet_axis_size, one.shard_spec) == (1, 1, "PartitionSpec('fleet')")
    assert (ref.n_devices, ref.fleet_axis_size, ref.shard_spec) == (1, 1, None)
    j1 = fleet["jax"][(1, "plain")]
    assert_events(j1, one)
    assert_counters(j1, one)
    masked = fleet["jax"][("masked", "plain")]
    assert_within_envelope(one, masked, bar=1e-4, what="1-plain",
                           perturbed=perturbations(lambda b: tsim.run_simulation(
                               configs("plain")[1], base_params=ulp(jax_init(), b))))
    assert (j1.n_devices, j1.fleet_axis_size, j1.shard_spec) == (
        one.n_devices, one.fleet_axis_size, one.shard_spec)


def test_one_rank_mesh_robust_world_bit_identical(one_rank):
    ref = port_fused("robust")
    one = tsim.run_simulation(dataclasses.replace(configs("robust")[1], mesh=one_rank),
                              base_params=jax_init())
    assert_bit_identical(ref, one)
    assert one.quarantined_commits == ref.quarantined_commits > 0


# ---------------------------------------------------------------------------
# 2 and 4 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,case", [(n, c) for n, cs in AT.items() for c in cs])
def test_ranks_match_the_jax_mesh(fleet, n, case):
    outs = [o[case] for o in fleet["port"][n]]
    for res in outs[1:]:
        assert_bit_identical(outs[0], res)
    port = outs[0]
    if case == "scenario":
        ref = fleet["jax"][(0, case)]
        masked = fleet["jax"][(0, "scenario_masked")]
    else:
        ref = fleet["jax"][(n, case)]
        masked = fleet["jax"][("masked", case)]
    # a data-dependent criterion ranks units by the trained params: its
    # events and the clocks after them go with the params oracle
    data_dependent = CASES[case][1].get("importance") in ("l1", "taylor")
    assert_events(masked if data_dependent else ref, port)
    assert_counters(ref, port)
    assert_events(masked, port)
    _, tc = configs(case)
    assert_within_envelope(
        port, masked, bar=1e-4, what=f"{n}-{case}",
        perturbed=perturbations(lambda b: tsim.run_simulation(tc, base_params=ulp(jax_init(), b))))
    assert (port.n_devices, port.fleet_axis_size, port.shard_spec) == (n, n, "PartitionSpec('fleet')")
    if case != "scenario":
        assert (ref.n_devices, ref.fleet_axis_size, ref.shard_spec) == (n, n, port.shard_spec)
    assert len(port.prune_events) > 0
    if case == "scenario":
        assert len(port.scenario_rounds) == 6 and any(j for *_, j in port.scenario_rounds)
    if case == "robust":
        assert port.quarantined_commits > 0
    if case == "dgc_regrow":
        assert port.comm_bytes < fleet["port"][4][0]["plain"].comm_bytes


def test_dispatches_flat_in_rank_count(fleet):
    ref = port_fused("plain")
    for n in AT:
        res = fleet["port"][n][0]["plain"]
        assert res.fused_chunks == ref.fused_chunks
        assert res.host_dispatches == ref.host_dispatches
        assert res.host_roundtrips == 0


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

class _Mesh:
    """The shape of a mesh, for the guards that fire before any collective."""

    def __init__(self, **shape):
        self.shape = shape


@pytest.mark.parametrize("shape,workers,match", [
    (dict(fleet=8), 5, "divide"),
    (dict(fleet=3), 8, "does not divide over the 3-way 'fleet' mesh axis"),
    (dict(data=2), 8, "no fleet axis 'fleet'"),
])
def test_mesh_guards_match_the_reference(shape, workers, match):
    sim = tsim.SimConfig(engine="fused", rounds=2, num_workers=workers, device="cpu",
                         het=THet(num_workers=workers, sigma=3.0), mesh=_Mesh(**shape))
    with pytest.raises(ValueError, match=match):
        tsim.run_simulation(sim)


def test_make_fleet_mesh_refuses_more_ranks_than_the_group(one_rank):
    with pytest.raises(ValueError, match="requested 2 devices, only 1 visible"):
        tmesh.make_fleet_mesh(2)
    assert one_rank.shape == {"fleet": 1} and one_rank.backend == "gloo"
    assert one_rank.device.type == "cpu"


def test_make_fleet_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="needs a running torch.distributed group"):
        tmesh.make_fleet_mesh(1)


@pytest.mark.cuda
def test_one_rank_nccl_group_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL has no CPU mode); run chip_smoke.py on the card")
    _, tc = configs("plain")
    cuda_sim = dataclasses.replace(tc, device="cuda")
    ref = tsim.run_simulation(cuda_sim, base_params=jax_init())
    with tmesh.fleet_group(device="cuda"):
        mesh = tmesh.make_fleet_mesh(1)
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        tcoll.reset_calls()
        one = tsim.run_simulation(dataclasses.replace(cuda_sim, mesh=mesh),
                                  base_params=jax_init())
        assert tcoll.CALLS["all_gather"] > 0
    assert_bit_identical(ref, one)


def test_a_failing_rank_fails_the_job_with_its_traceback():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="KeyError: 'no_such_entry'"):
        tmesh.run_ranks(2, tmesh.run_cases, ([("x", "no_such_entry", ())],), join_timeout_s=60)
    assert time.perf_counter() - t0 < 60
