"""Collectives of the mesh-sharded fleet over ``torch.distributed``.

Port of ``repro/sharding/collectives.py``, plus the ``psum`` the reference
calls inline (``psum_fleet``).  The reference runs one SPMD program under
``shard_map``; here each rank of a ``launch.mesh.FleetMesh`` is a process
holding its ``W_local`` rows, and the ranks meet only in these functions.
Shard ``s`` owns the global slots ``[s * W_local, (s+1) * W_local)``.

* ``all_gather_fleet`` gathers ``[W_local, ...]`` row blocks into the full
  ``[W, ...]`` stacks, tiled in rank order, so the gathered row ``w`` is
  global slot ``w``;
* ``shard_row_slice`` is its inverse: this rank's rows of a replicated
  full-fleet array;
* ``psum_fleet`` closes a two-tier reduction: every rank's partial sum is
  gathered and the partials are added in rank order.  A backend's own
  all-reduce picks its ring order; this order is fixed, so the sum is the
  same bits on every rank and on gloo and NCCL alike, at ``n x`` the bytes
  of one partial.

A tree is a tensor or a dict of tensors.  Its leaves are packed into one
buffer per dtype, so a call is one collective per dtype whatever the number
of leaves (``CALLS`` counts them).  At world size 1 every function returns
the values it was given, bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Union

import torch
import torch.distributed as dist

__all__ = ["all_gather_fleet", "shard_row_slice", "psum_fleet", "CALLS", "reset_calls"]

Tree = Union[torch.Tensor, Mapping[str, torch.Tensor]]

# backend collectives launched, by kind
CALLS: Dict[str, int] = {"all_gather": 0}


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _leaves(tree: Tree):
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    keys = list(tree)
    return [tree[k] for k in keys], lambda leaves: dict(zip(keys, leaves))


def _gather_rows(buf: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Every rank's ``buf`` (same shape on each), in rank order.  A one-rank
    mesh still goes through the backend, so its path is the one many ranks
    take."""
    wire = buf.to(torch.uint8) if buf.dtype == torch.bool else buf.contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    CALLS["all_gather"] += 1
    return [p.to(torch.bool) for p in parts] if buf.dtype == torch.bool else parts


def _by_dtype(leaves: List[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, v in enumerate(leaves):
        groups.setdefault(v.dtype, []).append(i)
    return groups


def all_gather_fleet(tree: Tree, mesh, dim: int = 0) -> Tree:
    """Gather each leaf's sharded row axis ``dim`` (``[..., W_local, ...]``)
    into the full fleet (``[..., W, ...]``), tiled in rank order."""
    leaves, rebuild = _leaves(tree)
    out: List[torch.Tensor] = [None] * len(leaves)
    for idx in _by_dtype(leaves).values():
        rows = [leaves[i].movedim(dim, 0) for i in idx]
        n_loc = rows[0].shape[0]
        widths = [int(r[0].numel()) for r in rows]
        buf = torch.cat([r.reshape(n_loc, -1) for r in rows], dim=1)
        full = torch.cat(_gather_rows(buf, mesh), dim=0)
        for i, r, part in zip(idx, rows, torch.split(full, widths, dim=1)):
            out[i] = part.reshape((full.shape[0],) + tuple(r.shape[1:])).movedim(0, dim)
    return rebuild(out)


def shard_row_slice(full: Tree, w_local: int, mesh) -> Tree:
    """This rank's ``[W_local, ...]`` rows of full-fleet leaves: the inverse
    of ``all_gather_fleet`` under the contiguous slot layout."""
    start = mesh.rank * w_local
    leaves, rebuild = _leaves(full)
    return rebuild([v[start : start + w_local] for v in leaves])


def psum_fleet(tree: Tree, mesh) -> Tree:
    """The sum over ranks of each leaf (same shape on every rank), added in
    rank order; the result is replicated, bit-identical on every rank."""
    leaves, rebuild = _leaves(tree)
    out: List[torch.Tensor] = [None] * len(leaves)
    for idx in _by_dtype(leaves).values():
        sizes = [int(leaves[i].numel()) for i in idx]
        buf = torch.cat([leaves[i].reshape(-1) for i in idx])
        parts = _gather_rows(buf, mesh)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        for i, part in zip(idx, torch.split(total, sizes)):
            out[i] = part.reshape(leaves[i].shape)
    return rebuild(out)
