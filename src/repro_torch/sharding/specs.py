"""The fleet's row layout (port of the fleet part of
``repro/sharding/specs.py``).

The reference places the resident ``[W, ...]`` stacks with a
``NamedSharding(mesh, PartitionSpec('fleet'))``: the worker dimension shards
over the fleet axis, everything after it is replicated.  Here a rank holds
its ``W_local`` rows itself, so the layout is a record: which axis, how many
shards, which rows this rank owns, and the spec string the reference
reports in ``SimResult.shard_spec``.  The LLM parameter and batch specs
belong to ROADMAP item A6.
"""
from __future__ import annotations

import dataclasses

__all__ = ["FleetSharding", "fleet_pspec", "fleet_sharding"]


def fleet_pspec(axis: str = "fleet") -> str:
    """The reference's ``PartitionSpec`` of the ``[W, ...]`` stacks, as the
    string it prints: one spec for params, masks, momentum and data."""
    return f"PartitionSpec({axis!r})"


@dataclasses.dataclass(frozen=True)
class FleetSharding:
    """Rows ``[row_offset, row_offset + w_local)`` of a ``[W, ...]`` stack
    live on this rank; ``num_shards`` ranks share the fleet axis."""

    axis: str
    num_shards: int
    rank: int

    def w_local(self, num_workers: int) -> int:
        if num_workers % self.num_shards:
            raise ValueError(f"fleet of {num_workers} workers does not divide over the "
                             f"{self.num_shards}-way fleet mesh axis")
        return num_workers // self.num_shards

    def row_offset(self, num_workers: int) -> int:
        return self.rank * self.w_local(num_workers)


def fleet_sharding(mesh, axis: str = "fleet") -> FleetSharding:
    """The row layout of ``[W, ...]`` stacks sharded over ``axis`` of a
    ``launch.mesh.FleetMesh``."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh axes {tuple(mesh.shape)} have no fleet axis {axis!r}")
    return FleetSharding(axis=axis, num_shards=int(mesh.shape[axis]), rank=int(mesh.rank))
