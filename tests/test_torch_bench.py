"""The port's runners (``repro_torch.bench``) against the reference's
(``benchmarks/tables.py``, ``benchmarks/run.py``).

1. Config-sequence parity, for all nine table rows and the nine sweeps,
   quick and full: ``run_simulation`` of both packages (and the port's
   mesh jobs, ``on_ranks``) is replaced by a recorder returning one canned
   result, so both runners must ask for the same ``SimConfig``s in the
   same order (field by field, the port's ``device`` aside, a mesh by its
   shape), print the same CSV lines letter for letter (elapsed seconds and
   JSON paths aside) and write the same JSON.
2. Real rows at a tiny size: a few rows run for real in both packages, cut
   to a tiny VGG and task, the port from the reference's init; the rows'
   exact fields (prune events, clocks, comm bytes, the FLOPs and blocks
   ledger, counters) are equal to the same-named JAX engine's; for the
   sweeps' cells params and accuracy are held to the JAX masked row under
   the envelope rule of ``torch_envelope``, for the table rows to the
   same-named JAX engine's at 1e-3.
3. ``retention_sweep(quick=True)`` at its own size, the same way, and
   ``shard_scale --quick`` against the reference's own run of it on 8
   virtual XLA devices (a subprocess), row by row in every field that is
   not a time.
4. The command line: ``roofline_table`` raises pointing at ROADMAP.md;
   every sweep is a command; a failing bench is not swallowed.

``benchmarks/`` has no ``__init__.py``; the repository root goes on
``sys.path`` here, so the tests do not depend on the working directory.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_envelope import assert_within_envelope, perturbations, ulp

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import run as jrun  # noqa: E402
from benchmarks import tables as jtables  # noqa: E402
from repro.core import simulation as jsim  # noqa: E402
from repro.data.synthetic import SyntheticImageTask as JTask  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.bench import run as trun  # noqa: E402
from repro_torch.bench import tables as ttables  # noqa: E402
from repro_torch.core import simulation as tsim  # noqa: E402
from repro_torch.data.synthetic import SyntheticImageTask as TTask  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

J_RUN, T_RUN = jsim.run_simulation, tsim.run_simulation   # before any patch
TABLES = [name for name, _ in ttables.BENCHES]
SWEEPS = ("scale", "async_scale", "fused", "retention_sweep", "shard_scale", "regrow_sweep",
          "world_model", "robust_world", "flaky_grid")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a result with every field the runners read; the same values in both packages
CANNED = dict(
    method="adaptcl", acc_time=[(0.0, 0.1), (9.5, 0.5)], final_acc=0.53125,
    best_acc=0.5625, best_acc_time=9.5, total_time=123.456789,
    het_traj=[(0, 0.41), (1, 0.33), (2, 0.21), (3, 0.12)], retentions=[1.0, 0.5],
    param_reduction=0.25, flops_reduction=0.375, comm_bytes=1.5e9, server_overhead_s=0.125,
    recompiles=3, similarity_traj=[(0, 0.9), (1, 0.75)], update_times=[[1.0, 2.0], [1.5, 3.0]],
    engine="masked", batched_calls=4, walltime_s=2.5, host_roundtrips=0, bucket_sizes=[2, 4],
    flops_executed=3.0e9, flops_ideal=2.0e9, blocks_executed=1.0e6,
    flops_per_image_final=1.0e6, blocks_per_image_final=100.0, host_dispatches=11,
    compile_walltime_s=0.5, fused_chunks=2, prune_events=[(2, 1, {"conv0": (0, 1)})],
    global_params={"fc/b": np.zeros(2, np.float32)},
)


def _canned(cls):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in CANNED.items() if k in names})


class _MeshShape:
    """What the recorder keeps of a port mesh job: its shape."""

    def __init__(self, n):
        self.shape = {"fleet": n}


def _canon(v):
    """A config as nested tuples of (field, value): dataclasses by their
    fields, so the two packages' classes compare by content; a mesh (the
    reference's ``jax.sharding.Mesh``, the port's job shape) by its shape."""
    if type(v).__name__ in ("Mesh", "_MeshShape", "FleetMesh"):
        return ("mesh", tuple(dict(v.shape).items()))
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,
                tuple((f.name, _canon(getattr(v, f.name))) for f in dataclasses.fields(v)))
    if isinstance(v, (list, tuple)):
        return tuple(_canon(x) for x in v)
    if isinstance(v, np.ndarray):
        return ("ndarray", v.dtype.str, v.shape, v.tobytes())
    return v


def _sim_fields(sim):
    """The reference's SimConfig fields of ``sim`` (the port's ``device``
    left out)."""
    return tuple((f.name, _canon(getattr(sim, f.name))) for f in dataclasses.fields(jsim.SimConfig))


# host walltimes of real runs differ between packages: cut from the lines
WALLS = [(re.compile(r"^(retention/(dense|block_skip)/r[^,]*),[^,]*,steady=[^;]*;compile=[^;]*;"),
          r"\1,"),
         (re.compile(r"^(engines/\w+/walltime_s),[^,]*,"), r"\1,"),
         (re.compile(r"speedup_vs_seq=[^;]*;"), "")]


def _no_walls(lines):
    for pat, rep in WALLS:
        lines = [pat.sub(rep, l) for l in lines]
    return lines


def _lines(text):
    return [l for l in text.splitlines()
            if "/_elapsed_s," not in l and "/json," not in l]


class Recorder:
    def __init__(self, result, real=None):
        self.configs, self.result, self.real = [], result, real

    def __call__(self, sim, **kw):
        self.configs.append(sim)
        return self.result if self.real is None else self.real(sim, self.result, **kw)

    def on_ranks(self, n, sim, device):
        """The port's mesh job (``run.on_ranks``), recorded with its shape."""
        return self(dataclasses.replace(sim, mesh=_MeshShape(n)))


def _patch_reference(monkeypatch, rec, quick):
    monkeypatch.setattr(jtables, "run_simulation", rec)
    monkeypatch.setattr(jsim, "run_simulation", rec)     # run.py imports it per call
    monkeypatch.setattr(jtables, "ROUNDS", 8 if quick else 12)
    monkeypatch.setattr(jtables, "PI", 4 if quick else 5)
    monkeypatch.setattr(jtables, "ENGINE", "sequential")


def _patch_port(monkeypatch, rec):
    monkeypatch.setattr(ttables, "run_simulation", rec)
    monkeypatch.setattr(trun, "run_simulation", rec)
    monkeypatch.setattr(trun, "on_ranks", getattr(rec, "on_ranks", rec))


def _both(name, quick, monkeypatch, capsys, tmp_path, j_real=None, t_real=None):
    """Run one table row or sweep through both packages; returns
    (reference recorder, lines, json), (port recorder, lines, json)."""
    out = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            rec = Recorder(_canned(jsim.SimResult), j_real)
            _patch_reference(monkeypatch, rec, quick)
        else:
            rec = Recorder(_canned(tsim.SimResult), t_real)
            _patch_port(monkeypatch, rec)
        path = tmp_path / f"{pkg}_{name}.json"
        capsys.readouterr()
        if name in SWEEPS:
            if pkg == "ref":
                getattr(jrun, name)(str(path), quick=quick)
            else:
                getattr(trun, name)(str(path), quick=quick, device="cpu")
        elif pkg == "ref":
            getattr(jtables, name)()
        else:
            getattr(ttables, name)(ttables.Settings(quick=quick, device="cpu"))
        text = capsys.readouterr().out
        blob = json.loads(path.read_text()) if path.exists() else None
        out.append((rec, _lines(text), blob))
    return out


# ---------------------------------------------------------------------------
# 1. config sequences, CSV lines and JSON, every row, quick and full
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
@pytest.mark.parametrize("name", TABLES + list(SWEEPS))
def test_runner_asks_for_the_reference_configs(name, quick, monkeypatch, capsys, tmp_path):
    (jr, jl, jj), (tr, tl, tj) = _both(name, quick, monkeypatch, capsys, tmp_path)
    assert jr.configs, name
    assert len(tr.configs) == len(jr.configs)
    for i, (a, b) in enumerate(zip(jr.configs, tr.configs)):
        assert _sim_fields(b) == _sim_fields(a), (name, i)
        assert b.device == "cpu"
    assert tl == jl and len(tl) >= 2
    assert tj == jj
    if name in SWEEPS:
        assert set(tj) == set(jj) and tj.get("checks", {}).keys() == jj.get("checks", {}).keys()


# ---------------------------------------------------------------------------
# 2. real rows at a tiny size
# ---------------------------------------------------------------------------

TINY_PLAN = [8, "M", 16]
# 200 images: every non-IID shard holds 20, so a padded batch is full (a
# shard under half a batch gives a short one, which no stacked engine takes);
# 5 rounds: the first prune event (round 4 in quick mode) trains a round
TINY_TASK = dict(num_classes=10, image_size=8, train_size=200, test_size=64)
TINY_ROUNDS = 5
EXACT = ("prune_events", "update_times", "retentions", "het_traj", "similarity_traj",
         "comm_bytes", "flops_executed", "flops_ideal", "blocks_executed",
         "flops_per_image_final", "blocks_per_image_final", "param_reduction",
         "flops_reduction", "recompiles", "host_dispatches", "batched_calls", "bucket_sizes",
         "host_roundtrips", "fused_chunks", "engine")


def _jax_init(cnn, seed):
    jcfg = jcnn.CNNConfig(**{f.name: getattr(cnn, f.name) for f in dataclasses.fields(cnn)})
    return {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(seed), jcfg).items()}


def _real(pick, shrink, store):
    """Run the configs ``pick`` selects for real (cut by ``shrink``); the
    rest get the canned result.  The port starts from the reference's init."""
    def j_real(sim, canned, **kw):
        if not pick(sim):
            return canned
        r = J_RUN(shrink(sim, jcnn.vgg_config, JTask))
        store["ref"].append(r)
        return r

    def t_real(sim, canned, **kw):
        if not pick(sim):
            return canned
        store.setdefault("sims", []).append(sim)
        sim = shrink(sim, tcnn.vgg_config, TTask)
        if isinstance(sim.mesh, _MeshShape):     # the port's mesh job, for real
            n = sim.mesh.shape["fleet"]
            r = tmesh.run_ranks(n, tmesh.simulate, (dataclasses.replace(sim, mesh=None),
                                                    _jax_init(sim.cnn, sim.seed)))[0]
            store["port"].append(r)
            return r
        r = T_RUN(sim, base_params=_jax_init(sim.cnn, sim.seed))
        store["port"].append(r)
        return r

    return j_real, t_real


def _tiny(sim, vgg, Task):
    return dataclasses.replace(sim, cnn=vgg("t", TINY_PLAN, num_classes=10, image_size=8),
                               task=Task(seed=sim.seed, **TINY_TASK), rounds=TINY_ROUNDS)


def _as_is(sim, vgg, Task):
    return sim


def _hold(rj, rt, what):
    for f in EXACT:
        assert getattr(rt, f) == getattr(rj, f), (what, f)
    assert abs(rt.total_time - rj.total_time) <= 1e-9, what
    assert abs(rt.final_acc - rj.final_acc) <= 1e-3, what
    assert abs(rt.best_acc - rj.best_acc) <= 1e-3, what


ROWS = {
    "table2_noniid": ("table2_main", lambda s: s.noniid_s == 80.0
                      and s.method in ("adaptcl", "fedavg_s"), 2),
    "table17_dgc0.9": ("table17_dgc", lambda s: s.dgc_sparsity == 0.9, 1),
    "fig5_by_unit": ("fig5_aggregation", lambda s: s.aggregation == "by_unit", 1),
    "engines_masked": ("engines", lambda s: s.engine == "masked", 1),
}


@pytest.mark.parametrize("row", list(ROWS))
def test_real_rows_meet_the_parity_contract(row, monkeypatch, capsys, tmp_path):
    name, pick, n = ROWS[row]
    store = {"ref": [], "port": []}
    j_real, t_real = _real(pick, _tiny, store)
    (_, jl, _), (_, tl, _) = _both(name, True, monkeypatch, capsys, tmp_path, j_real, t_real)
    assert len(store["ref"]) == len(store["port"]) == n
    for rj, rt in zip(store["ref"], store["port"]):
        _hold(rj, rt, row)
        if rj.method == "adaptcl":
            assert rt.prune_events and min(rt.retentions) < 1.0, row
    assert _no_walls(tl) == _no_walls(jl)


def _only_fault(family):
    """Pick the runs whose one fault family is ``family``."""
    def pick(sim):
        faults = sim.scenario.faults if sim.scenario is not None else None
        if faults is None:
            return False
        on = [f.name for f in dataclasses.fields(faults) if getattr(faults, f.name) is not None]
        return on == [family]
    return pick


# sweep cells run for real: (sweep, pick, expected runs); robust_byz's third
# run is the sweep's one-rank mesh leg (a spawned gloo rank in the port)
SWEEP_ROWS = {
    "world_crash": ("world_model", _only_fault("crash"), 2),
    "robust_byz": ("robust_world", lambda s: _only_fault("byzantine")(s) and s.robust is not None,
                   3),
    "regrow_cosine": ("regrow_sweep", lambda s: s.regrow is not None
                      and s.regrow.schedule == "cosine", 2),
}


@pytest.mark.parametrize("row", list(SWEEP_ROWS))
def test_real_sweep_rows_meet_the_parity_contract(row, monkeypatch, capsys, tmp_path):
    """A sweep's masked and fused rows for real at the tiny size: each port
    row has the exact fields of the JAX row of the same engine, and params
    and final_acc of JAX masked under the envelope rule (the port's row
    from the init one ulp up and down and in the other summation order)."""
    name, pick, n = SWEEP_ROWS[row]
    store = {"ref": [], "port": []}
    j_real, t_real = _real(pick, _tiny, store)
    (_, jl, jj), (_, tl, tj) = _both(name, True, monkeypatch, capsys, tmp_path, j_real, t_real)
    assert len(store["ref"]) == len(store["port"]) == n
    j_masked = next(r for r in store["ref"] if r.engine == "masked")
    for i, (rj, rt) in enumerate(zip(store["ref"][:2], store["port"][:2])):
        assert rt.engine == rj.engine
        for f in EXACT:
            if f == "update_times":     # NaN where a slot sat a round out
                np.testing.assert_array_equal(np.array(rt.update_times, dtype=float),
                                              np.array(rj.update_times, dtype=float))
            else:
                assert getattr(rt, f) == getattr(rj, f), (row, rj.engine, f)
        assert abs(rt.total_time - rj.total_time) <= 1e-9
        assert rt.prune_events and min(rt.retentions) < 1.0, row
        sim = _tiny(store["sims"][i], tcnn.vgg_config, TTask)
        init = _jax_init(sim.cnn, sim.seed)
        assert_within_envelope(
            rt, j_masked, bar=1e-4, what=f"{row}/{rt.engine}",
            perturbed=perturbations(lambda b, sim=sim, init=init: T_RUN(
                sim, base_params=ulp(init, b))))
    assert set(tj) == set(jj) and tj["checks"].keys() == jj["checks"].keys()
    if row == "robust_byz":     # the mesh leg: one rank is the no-mesh run, bit for bit
        assert (store["port"][2].n_devices, store["ref"][2].n_devices) == (1, 1)
        assert tj["checks"]["mesh_1dev_bit_identical"] and jj["checks"]["mesh_1dev_bit_identical"]


def test_retention_sweep_rows_at_its_own_size(monkeypatch, capsys, tmp_path):
    """Both packages' quick sweep (the block-skip path: Pallas in interpret
    mode in the reference, the kernel's plain version here) row for row."""
    store = {"ref": [], "port": []}
    j_real, t_real = _real(lambda s: True, _as_is, store)
    (_, jl, jj), (_, tl, tj) = _both("retention_sweep", True, monkeypatch, capsys, tmp_path,
                                     j_real, t_real)
    assert len(store["port"]) == 4
    for rj, rt in zip(store["ref"], store["port"]):
        _hold(rj, rt, rj.compute)
    exact = ("compute", "retention_target", "retention_realized", "flops_executed",
             "flops_ideal", "flops_ratio", "blocks_executed", "flops_per_image_final",
             "blocks_per_image_final", "recompiles")
    for a, b in zip(jj["rows"], tj["rows"]):
        assert set(a) == set(b)
        assert {k: b[k] for k in exact} == {k: a[k] for k in exact}
        assert abs(a["final_acc"] - b["final_acc"]) <= 1e-3
    assert tj["checks"] == jj["checks"]
    assert all(v for k, v in tj["checks"].items() if k != "quarter_blocks_over_full")
    assert _no_walls(tl) == _no_walls(jl)


def test_shard_scale_quick_rows_match_the_reference_run(monkeypatch, capsys, tmp_path):
    """``shard_scale --quick`` of both packages for real: the reference on 8
    virtual XLA devices in a subprocess (its command sets the flag), the
    port on gloo ranks, from the reference's init.  Row by row, every field
    that is not a time: W, n_dev, shard spec, dispatches, chunks,
    recompiles, final_acc (within 1e-3), and the checks' booleans but the
    speed check; prune-event identity is the reference's own check."""
    ref_out = tmp_path / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "benchmarks.run", "shard_scale", "--quick",
                           "--out", str(ref_out)], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(ref_out.read_text())
    assert ref["device_counts"] == [1, 2, 4, 8]

    def with_init(sim):
        return _jax_init(sim.cnn, sim.seed)

    monkeypatch.setattr(trun, "run_simulation",
                        lambda sim: T_RUN(sim, base_params=with_init(sim)))
    monkeypatch.setattr(trun, "on_ranks", lambda n, sim, device: tmesh.run_ranks(
        n, tmesh.simulate, (sim, with_init(sim)), device=device)[0])
    out = tmp_path / "port.json"
    trun.shard_scale(str(out), quick=True, device="cpu")
    port = json.loads(out.read_text())
    assert port["device_counts"] == ref["device_counts"]
    assert port["worker_counts"] == ref["worker_counts"]
    assert port["round_fusion"] == ref["round_fusion"]
    assert len(port["rows"]) == len(ref["rows"]) == 7
    same = ("workers", "n_dev", "shard_spec", "rounds", "round_fusion", "host_dispatches",
            "fused_chunks", "recompiles")
    for a, b in zip(ref["rows"], port["rows"]):
        assert {k: b[k] for k in same} == {k: a[k] for k in same}
        assert abs(a["final_acc"] - b["final_acc"]) <= 1e-3, (a, b)
    booleans = ("host_dispatches_flat_in_n_dev", "prune_indices_bit_identical")
    assert {k: port["checks"][k] for k in booleans} == {k: ref["checks"][k] for k in booleans}
    assert all(port["checks"][k] for k in booleans)
    assert port["checks"].keys() == ref["checks"].keys()
    assert isinstance(port["checks"]["steady_within_2_5x_of_single_device"], bool)
    capsys.readouterr()


# ---------------------------------------------------------------------------
# 4. the command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["tables", "--only", "roofline_table"]])
def test_unported_commands_point_at_the_roadmap(argv):
    with pytest.raises(ValueError, match="ROADMAP.md"):
        trun.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("cmd,out", [("shard_scale", "shard"), ("regrow_sweep", "regrow"),
                                     ("world_model", "world"), ("robust_world", "robust"),
                                     ("flaky_grid", "world")])
def test_slice_12_sweeps_are_commands(cmd, out, monkeypatch, capsys, tmp_path):
    """The five sweeps are commands of ``main``, writing
    ``BENCH_port_<out>.json`` by default (``flaky_grid`` merges into the
    world file, beside what is there)."""
    rec = Recorder(_canned(tsim.SimResult))
    _patch_port(monkeypatch, rec)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "BENCH_port_world.json").write_text(json.dumps({"rows": []}))
    assert trun.main([cmd, "--quick", "--device", "cpu", "--cnn", "vgg16"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,value,derived"
    assert lines[-1].endswith(f"/json,BENCH_port_{out}.json,")
    assert rec.configs and all(c.cnn == tcnn.VGG16_CIFAR and c.device == "cpu"
                               for c in rec.configs)
    blob = json.loads((tmp_path / f"BENCH_port_{out}.json").read_text())
    assert "checks" in (blob["flaky_grid"] if cmd == "flaky_grid" else blob)
    if cmd == "flaky_grid":
        assert blob["rows"] == []


def test_main_prints_the_reference_lines_and_raises_on_a_failing_bench(
        monkeypatch, capsys, tmp_path):
    rec = Recorder(_canned(tsim.SimResult))
    _patch_port(monkeypatch, rec)
    assert trun.main(["--quick", "--only", "overhead", "--device", "cpu", "--cnn", "vgg16"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,value,derived" and lines[-1].startswith("overhead/_elapsed_s,")
    assert [l.split(",")[0] for l in lines[1:-1]] == [
        "overhead/server_s", "overhead/recompiles", "overhead/comm_GB"]
    assert rec.configs[0].cnn == tcnn.VGG16_CIFAR and rec.configs[0].rounds == 8
    assert trun.main(["retention_sweep", "--quick", "--device", "cpu",
                      "--compute-blocks", "128,128,128", "--out", str(tmp_path / "r.json")]) == 0
    assert rec.configs[-1].compute_blocks == (128, 128, 128)

    def boom(sim, **kw):
        raise RuntimeError("bench failure")

    _patch_port(monkeypatch, boom)
    with pytest.raises(RuntimeError, match="bench failure"):
        trun.main(["--quick", "--only", "engines", "--device", "cpu"])


def test_settings_read_the_reference_environment(monkeypatch, capsys):
    """``main`` builds the tables' Settings from its flags and, as the
    reference's ``main`` does, from BENCH_QUICK=1 in the environment; the
    engine is always the flag's (the reference overwrites BENCH_ENGINE)."""
    rec = Recorder(_canned(tsim.SimResult))
    _patch_port(monkeypatch, rec)
    monkeypatch.setenv("BENCH_QUICK", "1")
    monkeypatch.setenv("BENCH_ENGINE", "masked")
    assert trun.main(["--only", "table14_interval", "--device", "cpu"]) == 0
    assert [(c.rounds, c.prune_interval, c.engine, c.device) for c in rec.configs] == [
        (8, 2, "sequential", "cpu"), (8, 4, "sequential", "cpu")]
    monkeypatch.delenv("BENCH_QUICK")
    rec.configs.clear()
    assert trun.main(["--only", "table14_interval", "--device", "cpu", "--engine", "bucketed"]) == 0
    assert [(c.rounds, c.prune_interval, c.engine) for c in rec.configs] == [
        (12, 2, "bucketed"), (12, 5, "bucketed")]
    capsys.readouterr()
    s = ttables.Settings(quick=True)
    assert (s.rounds, s.pi, s.engine, s.device, s.cnn) == (8, 4, "sequential", "cuda", None)
