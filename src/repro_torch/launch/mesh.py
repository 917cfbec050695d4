"""The meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``):
the fleet mesh, the LLM's ``(data, model)`` mesh and the production mesh
record, and a launcher of ranks on one node.

The reference's mesh is one controller over ``jax.devices()``; the port's
is one process per rank of a process group, each driving one device: NCCL
on the card, gloo on the CPU, and nothing falls back from one to the other.
``SimConfig.mesh = make_fleet_mesh(n)`` shards the fused sync engine's
``[W, ...]`` stacks over the ranks (``core.fused``).

* ``fleet_group`` — a context that starts the process group and destroys it:
  ``file://`` rendezvous at ``init_file`` (a temporary file for one rank),
  or ``env://`` under ``torchrun``;
* ``make_fleet_mesh(n_dev=None, axis="fleet")`` — the ``FleetMesh`` of the
  first ``n_dev`` ranks (default: all of them; more raises, as in the
  reference).  It runs one collective at once, so a group that cannot start
  raises here, and records how long that took (``init_s``);
* ``make_local_mesh(data=1, model=1)`` — the LLM's 2-D ``ModelMesh`` over
  the running group, ranks row-major with ``model`` minor (as
  ``jax.make_mesh``), one subgroup along each axis; ``with mesh:`` sets
  ``sharding.specs.current_mesh()``, under which ``models.moe`` takes its
  expert-parallel path.  As in the reference, ``data * model`` over the
  world size becomes ``(world, 1)``;
* ``make_production_mesh(multi_pod=False)`` — the ``(16, 16)`` /
  ``(2, 16, 16)`` shape record that the sharding rules read; it starts no
  group.  ``HARDWARE`` holds the card's datasheet figures;
* ``spawn_ranks`` / ``run_ranks`` — ``n`` spawned processes on this node,
  each calling ``target(mesh, *args)`` under its own group, with a group
  timeout and a join timeout.  ``target`` must live in this package
  (``run_cases`` and the entry points of ``ENTRIES``), so a rank imports
  ``repro_torch`` and nothing else.

On the CPU, from the repository root::

    PYTHONPATH=src python -m repro_torch.launch.mesh --ranks 4 --device cpu

runs one small fused adaptcl simulation on 4 gloo ranks and on one rank and
prints whether the 4 ranks' results are identical and how far their params
lie from the one-rank run's.  On a node with several cards, one rank per
card::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.mesh --torchrun

``--moe-ep ARCH`` serves ``ARCH`` (``--smoke``: its reduced config) on a
``(1, ranks)`` mesh, the experts split over the ranks (the ``moe_serve``
entry), against the same model on one rank in this process, and prints the
largest logit difference, whether two runs were bit-identical and what
each rank held::

    PYTHONPATH=src python -m repro_torch.launch.mesh --moe-ep granite-moe-1b-a400m --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.mesh --moe-ep granite-moe-1b-a400m --backend gloo
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.mesh --torchrun --moe-ep granite-moe-1b-a400m

(``--backend gloo`` on the card lets the ranks share one card, which NCCL
refuses.)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import pickle
import queue as _queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.sharding.specs import mesh_context

__all__ = [
    "HARDWARE",
    "ModelMesh",
    "ProductionMesh",
    "make_local_mesh",
    "make_production_mesh",
    "FleetMesh",
    "fleet_group",
    "make_fleet_mesh",
    "spawn_ranks",
    "run_ranks",
    "RankJob",
    "run_cases",
    "ENTRIES",
    "main",
]

GROUP_TIMEOUT_S = 60.0     # a collective waiting longer than this raises
JOIN_TIMEOUT_S = 240.0     # a spawned job taking longer than this is killed

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) datasheet figures, per card
HARDWARE = {
    "name": "NVIDIA H100 80GB HBM3",
    "peak_flops_bf16": 989e12,   # FLOP/s, dense bf16 tensor core (datasheet)
    "hbm_bandwidth": 3.35e12,    # bytes/s (datasheet)
    "nvlink_bandwidth": 450e9,   # bytes/s in each direction, NVLink 4 (datasheet)
    "hbm_bytes": 80e9,           # 80 GB (datasheet)
}


@dataclasses.dataclass(frozen=True, eq=False)
class FleetMesh:
    """A 1-D mesh: ``size`` ranks of ``group`` along ``axis``, this process
    being ``rank`` on ``device``.  ``shape`` is ``{axis: size}``, as a JAX
    mesh's; ``init_s`` the seconds the group's first collective took."""

    group: Any
    size: int
    rank: int
    device: torch.device
    axis: str = "fleet"
    init_s: float = 0.0

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.size}

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))


@contextlib.contextmanager
def fleet_group(world_size: Optional[int] = None, rank: Optional[int] = None, *,
                device="cuda", init_file: Optional[str] = None,
                timeout_s: float = GROUP_TIMEOUT_S, backend: Optional[str] = None):
    """Start the default process group for the duration of the context:
    NCCL when ``device`` is the card (each rank on card ``local rank``),
    gloo on the CPU; ``backend="gloo"`` with ``device="cuda"`` puts gloo
    ranks on the card (several ranks may share one, which NCCL refuses).
    Rendezvous at ``init_file`` (``file://``); without one under
    ``torchrun`` (``WORLD_SIZE`` set) at ``env://``, else a one-rank group
    on a temporary file."""
    dev = torch.device(device)
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already running")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("fleet_group(device='cuda') but no CUDA device is visible")
        backend = backend or "nccl"
    elif dev.type == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"fleet_group: no backend for device {device!r}")
    if (backend, dev.type) not in TRANSPORTS:
        raise ValueError(f"fleet_group: backend {backend!r} does not run on {dev.type}")
    tmp = None
    if init_file is None and "WORLD_SIZE" in os.environ:
        method = "env://"
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        world_size = 1 if world_size is None else world_size
        rank = 0 if rank is None else rank
        if init_file is None:
            if world_size != 1:
                raise ValueError("the ranks of a multi-rank group need a shared init_file")
            tmp = tempfile.mkdtemp(prefix="fleet_group_")
            init_file = os.path.join(tmp, "store")
        method = f"file://{init_file}"
        local = rank
    if dev.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def make_fleet_mesh(n_dev: Optional[int] = None, axis: str = "fleet") -> FleetMesh:
    """The 1-D fleet mesh of the first ``n_dev`` ranks of the running group
    (default: every rank).  Every rank of the group must call it."""
    if not dist.is_initialized():
        raise RuntimeError("make_fleet_mesh needs a running torch.distributed group: "
                           "enter launch.mesh.fleet_group(...) or start under torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_dev is None else int(n_dev)
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} visible")
    if n < 1:
        raise ValueError(f"a fleet mesh needs at least one rank, got {n}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the {n}-rank fleet mesh")
    backend = dist.get_backend(group)
    device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
              else torch.device("cpu"))
    t0 = time.perf_counter()
    probe = torch.zeros(1, device=device)
    parts = [torch.empty_like(probe) for _ in range(n)]
    dist.all_gather(parts, probe, group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return FleetMesh(group=group, size=n, rank=rank, device=device, axis=axis,
                     init_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# the LLM's (data, model) mesh and the production record
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class ProductionMesh(mesh_context):
    """The reference's production mesh as a shape record: axis name to
    size.  The sharding rules read only ``shape``; ``with mesh:`` sets
    ``current_mesh()`` as the reference's does, but no rank sits on it, so
    nothing executes under it (``models.moe`` refuses it)."""

    shape: Dict[str, int]

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))


def make_production_mesh(*, multi_pod: bool = False) -> ProductionMesh:
    """Single pod: 16 x 16 = 256 devices, axes (data, model).  Multi-pod:
    2 x 16 x 16 = 512, axes (pod, data, model); ``pod`` is the cross-pod
    data-parallel axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ProductionMesh(dict(zip(axes, shape)))


class ModelMesh(mesh_context):
    """A 2-D ``(data, model)`` mesh of ranks of the running group.  This
    process sits at ``coords`` (axis name to index) on ``device``;
    ``axes[name]`` is a ``FleetMesh`` of the ranks that share its other
    coordinate, whose ``group`` the collectives of that axis run over
    (``sharding.collectives``), and ``group`` holds every rank of the mesh.
    ``transport`` names how the collectives move the tensors: ``"nccl"``,
    ``"gloo"`` (CPU tensors) or ``"gloo-cuda"``: gloo ranks on the card
    (several may share one, which NCCL refuses), whose collectives gloo
    takes on card tensors itself, copying them through host memory."""

    def __init__(self, shape, coords, axes, device, transport, rank, group, init_s=0.0):
        self.group = group
        self.shape = dict(shape)
        self.coords = dict(coords)
        self.axes = dict(axes)
        self.device = device
        self.transport = transport
        self.rank = rank
        self.init_s = init_s

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))


# the transport of each (backend, device) pair a group may run: gloo takes
# every collective on card tensors (all_gather, all_reduce, broadcast,
# gather, reduce, reduce_scatter, all_to_all; PERF.md section 6, PR 30)
TRANSPORTS = {("nccl", "cuda"): "nccl", ("gloo", "cpu"): "gloo", ("gloo", "cuda"): "gloo-cuda"}


def make_local_mesh(data: int = 1, model: int = 1, *, device=None) -> Optional[ModelMesh]:
    """The ``(data, model)`` mesh of the first ``data * model`` ranks of the
    running group (``data * model`` over the world size becomes
    ``(world, 1)``, the reference's rule).  Rank ``r`` sits at
    ``(r // model, r % model)``.  Every rank of the group must call it (the
    subgroups are collective to create); a rank past the mesh gets None.
    ``device`` defaults to the card under NCCL and the CPU under gloo;
    ``device="cuda"`` under gloo puts this rank on the card (ranks sharing
    one card)."""
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs a running torch.distributed group: "
                           "enter launch.mesh.fleet_group(...) or start under torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data * model > world:
        data, model = world, 1
    backend = str(dist.get_backend())
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    transport = TRANSPORTS.get((backend, device.type))
    if transport is None:
        raise ValueError(f"make_local_mesh: backend {backend} does not run on {device}")
    n = data * model
    t0 = time.perf_counter()
    rows = [list(range(d * model, (d + 1) * model)) for d in range(data)]
    cols = [list(range(m, n, model)) for m in range(model)]
    whole = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    mine = {}
    for name, lists in (("model", rows), ("data", cols)):
        for ranks in lists:
            g = dist.new_group(ranks)     # every rank creates every group
            if rank in ranks:
                mine[name] = (g, ranks)
    if rank >= n:
        return None
    coords = {"data": rank // model, "model": rank % model}
    axes = {name: FleetMesh(group=g, size=len(ranks), rank=ranks.index(rank), device=device,
                            axis=name)
            for name, (g, ranks) in mine.items()}
    mesh = ModelMesh({"data": data, "model": model}, coords,
                     {"data": axes["data"], "model": axes["model"]}, device, transport, rank,
                     group=whole)
    from repro_torch.sharding.collectives import all_gather_fleet

    for axis in mesh.axes.values():
        all_gather_fleet(torch.zeros(1, device=device), axis)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    mesh.init_s = time.perf_counter() - t0
    return mesh


# ---------------------------------------------------------------------------
# the launcher: n ranks on this node
# ---------------------------------------------------------------------------

def _rank_main(rank, n, init_file, device, timeout_s, axis, job_file, results, backend=None):
    torch.set_num_threads(1)
    try:
        with open(job_file, "rb") as f:
            target, args = pickle.load(f)
        with fleet_group(n, rank, device=device, init_file=init_file, timeout_s=timeout_s,
                         backend=backend):
            out = target(make_fleet_mesh(n, axis), *args)
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:      # reported to the parent, which raises it there
        results.put((rank, False, traceback.format_exc()))
        raise


class RankJob:
    """``n`` spawned ranks running one target; ``join`` collects their
    results in rank order, or raises the first failure, or kills them all
    past its timeout."""

    def __init__(self, procs, results, tmp: str):
        self.procs = procs
        self.results = results
        self.tmp = tmp

    def join(self, timeout_s: float = JOIN_TIMEOUT_S) -> List[Any]:
        n = len(self.procs)
        got: Dict[int, Any] = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"fleet job: ranks {sorted(set(range(n)) - set(got))} "
                                       f"did not finish within {timeout_s} s")
                try:
                    rank, ok, payload = self.results.get(timeout=min(left, 1.0))
                except _queue.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"fleet job: ranks {dead} died with codes "
                                           f"{[self.procs[r].exitcode for r in dead]}")
                    continue
                if not ok:
                    raise RuntimeError(f"fleet job: rank {rank} failed:\n{payload}")
                got[rank] = pickle.loads(payload)
            return [got[r] for r in range(n)]
        finally:
            self.close()

    def close(self) -> None:
        for p in self.procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(self.tmp, ignore_errors=True)


def spawn_ranks(n: int, target: Callable, args: Sequence = (), *, device="cpu",
                axis: str = "fleet", timeout_s: float = GROUP_TIMEOUT_S,
                backend: Optional[str] = None) -> RankJob:
    """Start ``n`` ranks (spawned processes, one torch thread each), each
    calling ``target(mesh, *args)`` with its ``FleetMesh``; returns at once.
    The group meets at a file in a fresh temporary directory, so jobs
    running side by side never share a rendezvous.  ``backend``: as
    ``fleet_group``'s."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="fleet_ranks_")
    init_file = os.path.join(tmp, "store")
    # the target and its arguments reach the ranks through a file: through
    # the spawn pipe a few MB of arrays took seconds
    job_file = os.path.join(tmp, "job.pkl")
    with open(job_file, "wb") as f:
        pickle.dump((target, tuple(args)), f, protocol=pickle.HIGHEST_PROTOCOL)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, init_file, str(device), timeout_s, axis, job_file,
                               results, backend))
             for r in range(n)]
    for p in procs:
        p.start()
    return RankJob(procs, results, tmp)


def run_ranks(n: int, target: Callable, args: Sequence = (), *, device="cpu",
              axis: str = "fleet", timeout_s: float = GROUP_TIMEOUT_S,
              join_timeout_s: float = JOIN_TIMEOUT_S, backend: Optional[str] = None) -> List[Any]:
    """``spawn_ranks`` and ``join``: each rank's return value, in rank order."""
    return spawn_ranks(n, target, args, device=device, axis=axis, timeout_s=timeout_s,
                       backend=backend).join(join_timeout_s)


# ---------------------------------------------------------------------------
# rank entry points
# ---------------------------------------------------------------------------

def simulate(mesh: FleetMesh, sim, base_params=None):
    """``run_simulation`` of ``sim`` on this rank of ``mesh``."""
    from repro_torch.core.simulation import run_simulation

    return run_simulation(dataclasses.replace(sim, mesh=mesh), base_params=base_params)


def collectives(mesh: FleetMesh, stacks, masks, weights, submitters):
    """This rank's rows of full-fleet numpy ``[W, ...]`` stacks through the
    collectives and the two-tier aggregations; returns numpy results."""
    from repro_torch.core.aggregation import (
        aggregate_by_unit_stacked_dev,
        aggregate_by_worker_stacked_dev,
    )
    from repro_torch.sharding.collectives import (
        all_gather_fleet,
        psum_fleet,
        shard_row_slice,
    )

    W = len(weights)
    wl = W // mesh.size
    rows = slice(mesh.rank * wl, (mesh.rank + 1) * wl)
    loc = {k: torch.as_tensor(v[rows], device=mesh.device) for k, v in stacks.items()}
    loc_m = {k: torch.as_tensor(v[rows], device=mesh.device) for k, v in masks.items()}
    full_w = torch.as_tensor(weights, device=mesh.device)
    w = shard_row_slice(full_w, wl, mesh)
    sub = torch.as_tensor(submitters[rows], device=mesh.device)
    out = {
        "gathered": all_gather_fleet(loc, mesh),
        "gathered_dim1": all_gather_fleet({k: v.movedim(0, 1) for k, v in loc.items()}, mesh,
                                          dim=1),
        "row_slice": w,
        "psum": psum_fleet({k: v.sum(dim=0) for k, v in loc.items()}, mesh),
        "by_worker": aggregate_by_worker_stacked_dev(loc, w, mesh),
        "by_unit": aggregate_by_unit_stacked_dev(loc, loc_m, sub, mesh),
    }
    return _to_numpy(out)


def collab(mesh: FleetMesh, global_params, masks, x, y, lr, steps, batch_size):
    """One ``core.collab.collab_round`` with this rank as worker ``rank``:
    its mask row and its ``len(x) / n`` images of the full-fleet inputs."""
    from repro_torch.core.collab import collab_round, linear_softmax_loss

    n_loc = len(x) // mesh.size
    r = mesh.rank
    dev = mesh.device
    out = collab_round(
        linear_softmax_loss,
        {k: torch.as_tensor(v, device=dev) for k, v in global_params.items()},
        {k: torch.as_tensor(v[r : r + 1], device=dev) for k, v in masks.items()},
        torch.as_tensor(x[r * n_loc : (r + 1) * n_loc], device=dev),
        torch.as_tensor(y[r * n_loc : (r + 1) * n_loc], device=dev),
        mesh, lr=lr, steps=steps, batch_size=batch_size, axis=mesh.axis,
    )
    return _to_numpy(out)


def collective_times(mesh: FleetMesh, shapes, iters: int = 20):
    """ms of one ``psum_fleet`` over float32 tensors of ``shapes`` (a
    round's by-worker aggregation) beside one ``dist.all_reduce`` of the
    same bytes (the library's ring, whose summation order is its own);
    CUDA events on the card, the host clock on the CPU."""
    from repro_torch.sharding.collectives import psum_fleet

    gen = torch.Generator().manual_seed(mesh.rank)
    tree = {k: torch.randn(tuple(v), generator=gen).to(mesh.device) for k, v in shapes.items()}
    flat = torch.cat([v.reshape(-1) for v in tree.values()])

    def timed(fn):
        fn()
        if mesh.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / iters
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters

    return {"bytes": int(flat.numel() * 4), "psum_fleet_ms": timed(lambda: psum_fleet(tree, mesh)),
            "all_reduce_ms": timed(lambda: dist.all_reduce(flat.clone(), group=mesh.group))}


def first_moe_params(params, cfg):
    """The first MoE layer's ``moe`` params (views) of a model tree."""
    from repro_torch.models import transformer as T

    g, rem = T._split_layers(cfg)
    if g > 0:
        for j, kind in enumerate(cfg.block_pattern):
            if kind in ("moe", "moe_local"):
                return T._group(params["blocks"][f"s{j}"]["moe"], 0)
    for i, kind in enumerate(rem):
        if kind in ("moe", "moe_local"):
            return params["rem"][i]["moe"]
    raise ValueError(f"{cfg.name} has no MoE layer")


def _cut_in_place(tree, specs, mesh) -> None:
    """``shard_tree`` leaf by leaf inside ``tree``: each cut leaf replaced by
    its block as soon as that is copied, so the full tree is never held
    beside its blocks."""
    from repro_torch.sharding.specs import local_slice

    for k in (range(len(tree)) if isinstance(tree, list) else list(tree)):
        if isinstance(tree[k], (dict, list)):
            _cut_in_place(tree[k], specs[k], mesh)
        elif any(a is not None for a in specs[k]):
            tree[k] = local_slice(tree[k], specs[k], mesh).clone()


def _timed_ms(fn, dev, iters: int = 10) -> float:
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3 / iters


def moe_serve(world: FleetMesh, cases):
    """Expert-parallel serving on the ranks of ``world``: for each case (a
    dict), the ``(data, model)`` mesh of ``make_local_mesh(case["data"],
    case["model"], device=)``, the model ``case["cfg"]`` drawn
    from ``case["seed"]`` on the mesh's device by each rank in turn and cut
    to its block at once (``models.moe.ep_pspec``), then under ``with
    mesh:`` ``case["runs"]`` times a prefill of ``case["prompts"]`` and a
    decode step for each column of ``case["forced"]`` (the tokens fed, as a
    greedy serve fed them), routing recorded by ``RoutingSpy`` (replaying
    ``case["replay"]`` where given).  With ``case["first_x"]``, also the
    first MoE layer's ``moe_fwd`` on it.  Returns per case (None on a rank
    outside the mesh) numpy results of the first run, whether every later
    run was bit-identical, peak and held bytes, the flash launches of all
    runs, and the ms of one model-axis psum of the first layer's output,
    beside the same psum on a host copy (staged through host memory
    explicitly)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.launch.serve import serve_numerics
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.specs import tree_pspecs

    out = []
    for case in cases:
        mesh = make_local_mesh(case["data"], case["model"], device=case.get("device"))
        if mesh is None:
            out.append(None)
            continue
        cfg, dev = case["cfg"], mesh.device
        cuda = dev.type == "cuda"
        t0 = time.perf_counter()
        params = None
        for r in range(mesh.size):
            if mesh.rank == r:
                params = T.init_params(torch.Generator(device=dev).manual_seed(case["seed"]), cfg)
                _cut_in_place(params, tree_pspecs(params, mesh, moe_mod.ep_pspec(cfg.num_experts)),
                              mesh)
                if cuda:
                    torch.cuda.synchronize(dev)
                    torch.cuda.empty_cache()
            dist.barrier(group=mesh.group)
        init_s = time.perf_counter() - t0
        held = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        dt = T.param_dtype(cfg)
        prompts = torch.as_tensor(case["prompts"], device=dev)
        forced = torch.as_tensor(case["forced"], device=dev)
        replay = case.get("replay")
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        runs = []
        C.reset_calls()
        fa_mod.reset_launches()
        for _ in range(case.get("runs", 2)):
            spy = moe_mod.RoutingSpy(
                replay=None if replay is None else [torch.as_tensor(t, device=dev) for t in replay])
            t1 = time.perf_counter()
            with serve_numerics(), mesh, spy.installed():
                b, s = prompts.shape
                logits, state = T.prefill(params, cfg, {"tokens": prompts},
                                          max_len=s + forced.shape[1])
                kept = [logits]
                for j in range(forced.shape[1]):
                    logits, state = T.decode_step(params, cfg, state, forced[:, j])
                    kept.append(logits)
                first = None
                if case.get("first_x") is not None:
                    x = torch.as_tensor(case["first_x"], device=dev).to(dt)
                    with torch.no_grad():
                        first = moe_mod.moe_fwd(first_moe_params(params, cfg), T._moe_spec(cfg), x)
                if cuda:
                    torch.cuda.synchronize(dev)
            runs.append({"logits": torch.stack(kept, dim=1), "spy": spy, "first": first,
                         "seconds": time.perf_counter() - t1})
            del state
        calls = dict(C.CALLS)
        launches = {k: v for k, v in fa_mod.LAUNCHES.items()}
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        r0 = runs[0]
        same = all(torch.equal(r["logits"], r0["logits"])
                   and (r0["first"] is None or (torch.equal(r["first"][0], r0["first"][0])
                                                and torch.equal(r["first"][1], r0["first"][1])))
                   and all(torch.equal(a["counts"], b_["counts"])
                           for a, b_ in zip(r["spy"].calls, r0["spy"].calls))
                   for r in runs[1:])
        psum_ms = {}
        if r0["first"] is not None:
            y, axis = r0["first"][0], mesh.axes["model"]
            psum_ms[mesh.transport] = _timed_ms(lambda: C.psum_fleet(y, axis), dev)
            if cuda:
                psum_ms["host_staged"] = _timed_ms(lambda: C.psum_fleet(y.cpu(), axis).to(dev), dev)
        out.append({
            "coords": mesh.coords, "shape": mesh.shape, "transport": mesh.transport,
            "backend": mesh.axes["model"].backend, "init_s": init_s,
            "seconds": [r["seconds"] for r in runs], "runs_bit_identical": same,
            "held_bytes": held, "peak_bytes": peak, "collective_calls": calls,
            "flash_launches": launches,
            "psum_ms": psum_ms, "psum_bytes": None if r0["first"] is None
            else r0["first"][0].numel() * r0["first"][0].element_size(),
            "logits": r0["logits"].float().cpu().numpy(),
            "first_out": None if r0["first"] is None else r0["first"][0].float().cpu().numpy(),
            "first_aux": None if r0["first"] is None else float(r0["first"][1]),
            "routing": [{"T": c["T"], "C": c["C"], "k": c["k"],
                         "counts": c["counts"].cpu().numpy(),
                         "probs": c["probs"].float().cpu().numpy(),
                         "flipped": None if "flipped" not in c
                         else c["flipped"].cpu().numpy()} for c in r0["spy"].calls],
        })
        del params, runs, r0
        if cuda:
            torch.cuda.empty_cache()
    return out


def moe_layer(world: FleetMesh, cases):
    """``moe_fwd`` alone on the ranks of ``world``: for each case (a dict),
    the mesh of ``make_local_mesh(case["data"], case["model"])``, the full
    numpy ``case["params"]`` cut to this rank's block
    (``shard_tree(..., ep_pspec(E))``) and ``case["x"]``; returns per case
    (None outside the mesh) the output, aux, the routing of this rank's
    dispatch (T, C, counts) and the blocks it held."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.sharding.specs import shard_tree

    out = []
    for case in cases:
        mesh = make_local_mesh(case["data"], case["model"])
        if mesh is None:
            out.append(None)
            continue
        spec = case["spec"]
        full = {k: torch.as_tensor(v) for k, v in case["params"].items()}
        mine = shard_tree({"moe": full}, mesh, moe_mod.ep_pspec(spec.num_experts))["moe"]
        spy = moe_mod.RoutingSpy()
        with torch.no_grad(), mesh, spy.installed():
            y, aux = moe_mod.moe_fwd(mine, spec, torch.as_tensor(case["x"]))
        out.append({"coords": mesh.coords, "out": y.numpy(), "aux": float(aux),
                    "held": {k: v.numpy() for k, v in mine.items()},
                    "routing": [{"T": c["T"], "C": c["C"], "counts": c["counts"].numpy()}
                                for c in spy.calls]})
    return out


ENTRIES: Dict[str, Callable] = {"simulate": simulate, "collectives": collectives,
                                "collab": collab, "collective_times": collective_times,
                                "moe_serve": moe_serve, "moe_layer": moe_layer}


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree


def run_cases(mesh: FleetMesh, cases):
    """Run ``cases``, a list of ``(name, entry, args)`` with ``entry`` a key
    of ``ENTRIES``, on this rank: ``{name: entry(mesh, *args)}``, and the
    backend collectives each case launched (``sharding.collectives.CALLS``)
    under ``"_calls"``."""
    from repro_torch.sharding import collectives as C

    out, calls = {}, {}
    for name, entry, args in cases:
        C.reset_calls()
        out[name] = ENTRIES[entry](mesh, *args)
        calls[name] = dict(C.CALLS)
    out["_calls"] = calls
    return out


# ---------------------------------------------------------------------------
# command line: a fused simulation on n ranks against one rank
# ---------------------------------------------------------------------------

def _demo_sim(args):
    from repro_torch.core.simulation import SimConfig
    from repro_torch.models.cnn import VGG16_CIFAR, vgg_config

    cnn = (VGG16_CIFAR if args.cnn == "vgg16"
           else vgg_config("vgg_tiny_fused", [8, "M", 16], num_classes=4, image_size=8))
    # index order: cig_bnscalor's frozen BN scales tie at VGG16 width, and a
    # rounding difference (another summation order) can swap a pair
    return SimConfig(method="adaptcl", engine="fused", rounds=args.rounds, prune_interval=2,
                     importance="index",
                     num_workers=args.workers, batch_size=16 if args.cnn == "tiny" else 32,
                     seed=args.seed, cnn=cnn, device=args.device)


def _summary(res) -> Dict[str, Any]:
    return {"final_acc": res.final_acc, "total_time": res.total_time,
            "prune_events": len(res.prune_events), "fused_chunks": res.fused_chunks,
            "host_dispatches": res.host_dispatches, "n_devices": res.n_devices,
            "shard_spec": res.shard_spec, "walltime_s": res.walltime_s,
            "ms_per_round": res.walltime_s / max(len(res.update_times), 1) * 1e3,
            # after the first chunk (its first call, timed apart) of 2 rounds
            "steady_ms_per_round": (res.walltime_s - res.compile_walltime_s)
            / max(len(res.update_times) - 2, 1) * 1e3}


def _same(a, b) -> bool:
    return (a.prune_events == b.prune_events and a.update_times == b.update_times
            and all(np.array_equal(a.global_params[k], b.global_params[k])
                    for k in a.global_params))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cnn", default="tiny", choices=("tiny", "vgg16"),
                    help="the tests' tiny VGG, or VGG16_CIFAR at full width")
    ap.add_argument("--torchrun", action="store_true",
                    help="this process is one rank started by torchrun")
    ap.add_argument("--moe-ep", metavar="ARCH",
                    help="serve ARCH expert-parallel over the ranks (module docstring)")
    ap.add_argument("--smoke", action="store_true", help="--moe-ep: the reduced config")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="the group's backend (default: NCCL on the card, gloo on the CPU)")
    args = ap.parse_args(argv)
    if args.moe_ep:
        return _moe_ep_main(args)
    sim = _demo_sim(args)
    if args.torchrun:
        with fleet_group(device=args.device):
            mesh = make_fleet_mesh()
            res = simulate(mesh, sim)
            if mesh.rank == 0:
                print(json.dumps({"rank": 0, "ranks": mesh.size, **_summary(res)}), flush=True)
        return 0
    one = run_ranks(1, simulate, (sim,), device=args.device)[0]
    many = run_ranks(args.ranks, simulate, (sim,), device=args.device)
    shapes = {k: v.shape for k, v in one.global_params.items()}
    coll = {n: run_ranks(n, collective_times, (shapes,), device=args.device)[0]
            for n in sorted({1, args.ranks})}
    print(json.dumps({"ranks": args.ranks, "ranks_equal": all(_same(many[0], r) for r in many[1:]),
                      "events_equal_one_rank": many[0].prune_events == one.prune_events
                      and many[0].update_times == one.update_times,
                      "params_vs_one_rank": max(
                          float(np.abs(many[0].global_params[k] - one.global_params[k]).max())
                          for k in one.global_params),
                      "one_rank": _summary(one), "mesh": _summary(many[0]),
                      "collectives_by_ranks": coll}), flush=True)
    return 0


def _moe_ep_main(args) -> int:
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import transformer as T

    cfg = smoke_config(args.moe_ep) if args.smoke else get_config(args.moe_ep)
    if not cfg.num_experts:
        raise ValueError(f"--moe-ep: {cfg.name} has no experts")
    dev = torch.device(args.device)
    case = {"cfg": cfg, "seed": args.seed, "data": 1, "model": None, "device": args.device,
            "runs": 2}

    def summary(r, ref_logits=None):
        out = {k: r[k] for k in ("shape", "transport", "backend", "runs_bit_identical",
                                 "held_bytes", "peak_bytes", "psum_ms", "seconds")}
        out["dropped"] = [int(np.maximum(c["counts"] - c["C"], 0).sum()) for c in r["routing"]]
        if ref_logits is not None:
            out["max_logit_diff_vs_one_rank"] = float(np.abs(r["logits"] - ref_logits).max())
        return out

    if args.torchrun:
        with fleet_group(device=args.device, backend=args.backend):
            world = make_fleet_mesh()
            gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
            prompts = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=dev)
            case.update(model=world.size, prompts=prompts.cpu().numpy(),
                        forced=prompts[:, :4].cpu().numpy())
            r = moe_serve(world, [case])[0]
            if world.rank == 0:
                print(json.dumps({"arch": cfg.name, **summary(r)}), flush=True)
        return 0
    params = T.init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=dev)
    out, logits = serve_batch(cfg, params, prompts, 4, device=dev, return_logits=True)
    del params
    case.update(model=args.ranks, prompts=prompts.cpu().numpy(), forced=out.cpu().numpy())
    ranks = run_ranks(args.ranks, moe_serve, ([case],), device=args.device, backend=args.backend)
    ref = logits.float().cpu().numpy()
    print(json.dumps({"arch": cfg.name, "ranks": args.ranks,
                      "ranks_equal": all(np.array_equal(r[0]["logits"], ranks[0][0]["logits"])
                                         for r in ranks),
                      **summary(ranks[0][0], ref)}, default=float), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
