"""The fleet mesh over ``torch.distributed`` (port of ``make_fleet_mesh`` in
``repro/launch/mesh.py``), and a launcher of its ranks on one node.

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

__all__ = [
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
                timeout_s: float = GROUP_TIMEOUT_S):
    """Start the default process group for the duration of the context:
    NCCL when ``device`` is the card (each rank on card ``local rank``),
    gloo on the CPU.  Rendezvous at ``init_file`` (``file://``); without one
    under ``torchrun`` (``WORLD_SIZE`` set) at ``env://``, else a one-rank
    group on a temporary file."""
    dev = torch.device(device)
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group is already running")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("fleet_group(device='cuda') but no CUDA device is visible")
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"fleet_group: no backend for device {device!r}")
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
    if backend == "nccl":
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
# the launcher: n ranks on this node
# ---------------------------------------------------------------------------

def _rank_main(rank, n, init_file, device, timeout_s, axis, target, args, results):
    torch.set_num_threads(1)
    try:
        with fleet_group(n, rank, device=device, init_file=init_file, timeout_s=timeout_s):
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
                axis: str = "fleet", timeout_s: float = GROUP_TIMEOUT_S) -> RankJob:
    """Start ``n`` ranks (spawned processes, one torch thread each), each
    calling ``target(mesh, *args)`` with its ``FleetMesh``; returns at once.
    The group meets at a file in a fresh temporary directory, so jobs
    running side by side never share a rendezvous."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="fleet_ranks_")
    init_file = os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, init_file, str(device), timeout_s, axis, target, tuple(args),
                               results))
             for r in range(n)]
    for p in procs:
        p.start()
    return RankJob(procs, results, tmp)


def run_ranks(n: int, target: Callable, args: Sequence = (), *, device="cpu",
              axis: str = "fleet", timeout_s: float = GROUP_TIMEOUT_S,
              join_timeout_s: float = JOIN_TIMEOUT_S) -> List[Any]:
    """``spawn_ranks`` and ``join``: each rank's return value, in rank order."""
    return spawn_ranks(n, target, args, device=device, axis=axis,
                       timeout_s=timeout_s).join(join_timeout_s)


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


ENTRIES: Dict[str, Callable] = {"simulate": simulate, "collectives": collectives,
                                "collab": collab, "collective_times": collective_times}


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
    args = ap.parse_args(argv)
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


if __name__ == "__main__":
    raise SystemExit(main())
