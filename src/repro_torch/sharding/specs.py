"""Sharding rules (port of ``repro/sharding/specs.py``): the fleet's row
layout, and the LLM's parameter / batch / decode-state partitioning.

**The fleet.** The reference places the resident ``[W, ...]`` stacks with a
``NamedSharding(mesh, PartitionSpec('fleet'))``: the worker dimension shards
over the fleet axis, everything after it is replicated.  Here a rank holds
its ``W_local`` rows itself, so the layout is a record: which axis, how many
shards, which rows this rank owns, and the spec string the reference
reports in ``SimResult.shard_spec``.

**The LLM** ("FSDP + TP", MaxText-style), the reference's rules unchanged:

* ``model`` axis: tensor parallelism over attention heads (KV groups), FFN
  columns, experts, recurrent channels, vocab;
* ``data`` axis: batch parallelism for activations and fully-sharded
  parameters over d_model-like dims (ZeRO-3);
* ``pod`` axis (multi-pod): pure data parallelism across pods; batch
  shards over ``(pod, data)``, parameters are replicated across pods.

Every rule is divisibility-checked with fallbacks (kv_heads=8 cannot split
16-way, so head_dim is tried; an odd vocab shards d_model).  The rules read
only ``mesh.shape`` (a mapping of axis name to size), so they take the
reference tests' fake meshes, ``launch.mesh.make_local_mesh`` and the
``make_production_mesh`` record alike.  A spec is a plain tuple with one
entry a dimension: ``None``, an axis name, or a tuple of axis names; it
compares equal to ``tuple()`` of the reference's ``PartitionSpec``.

``shard_tree`` gives this rank's local slice of every leaf under a spec
(along a tuple of axes the first is major, as in JAX).  ``current_mesh``
returns the mesh entered with ``with mesh:``.  ``constrain`` is the
reference's GSPMD layout hint (``with_sharding_constraint``); the port's
forward runs no GSPMD, so it is the identity here and nothing calls it.
Where a whole LLM is placed under these rules (FSDP + TP) is ROADMAP A6's
open question; the one path that executes under a mesh is the MoE's
expert-parallel one (``models.moe``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Tuple

__all__ = [
    "FleetSharding",
    "fleet_pspec",
    "fleet_sharding",
    "current_mesh",
    "mesh_context",
    "constrain",
    "param_pspec",
    "tree_pspecs",
    "shard_tree",
    "local_slice",
    "batch_pspecs",
    "decode_state_pspecs",
    "FULL_DP",
]


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


# ---------------------------------------------------------------------------
# the LLM's rules
# ---------------------------------------------------------------------------

_ACTIVE = threading.local()


def current_mesh():
    """Mesh from the active ``with mesh:`` context, or None (smoke tests)."""
    stack = getattr(_ACTIVE, "stack", None)
    return stack[-1] if stack else None


class mesh_context:
    """Base of a mesh usable as ``with mesh:``: sets ``current_mesh()`` for
    the duration of the block (nested blocks stack, as JAX's do)."""

    def __enter__(self):
        if not hasattr(_ACTIVE, "stack"):
            _ACTIVE.stack = []
        _ACTIVE.stack.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.stack.pop()
        return False


def constrain(x, prefs):
    """The reference's activation layout hint under GSPMD; the identity
    here (module docstring)."""
    return x


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= mesh.shape[n]
        return out
    return mesh.shape[name]


def _fits(shape, dim: int, mesh, axis) -> bool:
    return dim < len(shape) and shape[dim] % _axis_size(mesh, axis) == 0


def _assign(shape, mesh, prefs) -> Tuple:
    """prefs: list of (dim, mesh_axis) tried in order; one mesh axis used once."""
    spec = [None] * len(shape)
    used = set()
    for dim, axis in prefs:
        if dim < 0:
            dim = len(shape) + dim
        flat = axis if isinstance(axis, tuple) else (axis,)
        if any(a in used for a in flat):
            continue
        if dim >= len(shape) or spec[dim] is not None:
            continue
        if _fits(shape, dim, mesh, axis):
            spec[dim] = axis
            used.update(flat)
    return _spec(spec)


def _spec(entries) -> Tuple:
    """A spec tuple as ``tuple(PartitionSpec(*entries))`` reads: a tuple
    of one axis name becomes the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


# rules keyed by the last path component (parameter leaf name); `stk` = 1
# when the leaf has a leading stacked-layers axis (blocks/...), shifting dims.
def param_pspec(path: str, shape: Tuple[int, ...], mesh) -> Tuple:
    has_model = "model" in mesh.shape
    has_data = "data" in mesh.shape
    if not (has_model and has_data):
        return ()
    name = path.split("/")[-1]
    stk = 1 if (("blocks" in path or "enc_blocks" in path) and len(shape) > 0) else 0
    if FULL_DP:
        # pure-DP: ZeRO-3 over the combined (data, model) axes, largest dim
        fsdp = tuple(a for a in ("data", "model") if a in mesh.shape)
        dims = sorted(range(stk, len(shape)), key=lambda d: -shape[d])
        return _assign(shape, mesh, [(d, fsdp) for d in dims])

    def A(*prefs):
        return _assign(shape, mesh, [(d + stk if d >= 0 else d, a) for d, a in prefs])

    if name in ("wq",):          # [D, H, hd]
        return A((1, "model"), (2, "model"), (0, "data"))
    if name in ("wk", "wv"):     # [D, KV, hd]: never split hd (rope splits it
        # in half); replicate KV over model when kv does not divide
        return A((1, "model"), (0, "data"))
    if name == "wo":             # [H, hd, D]
        return A((0, "model"), (1, "model"), (2, "data"))
    if name == "bq":             # [H, hd]
        return A((0, "model"))
    if name in ("bk", "bv"):
        return A((0, "model"))
    if name in ("w_up", "w_gate", "ws_up", "ws_gate"):
        if len(shape) - stk == 3:   # moe [E, D, F]
            return A((0, "model"), (1, "data"))
        return A((1, "model"), (0, "data"))      # [D, F]
    if name in ("w_down", "ws_down"):
        if len(shape) - stk == 3:   # moe [E, F, D]
            return A((0, "model"), (1, "data"))
        return A((0, "model"), (1, "data"))      # [F, D]
    if name == "w_router":       # [D, E]
        return A((1, "model"), (0, "data"))
    if name in ("w_y", "w_x"):   # rglru [D, R]
        return A((1, "model"), (0, "data"))
    if name == "w_out":          # rglru [R, D]
        return A((0, "model"), (1, "data"))
    if name == "conv":           # [w, R]
        return A((1, "model"))
    if name in ("gate_a", "gate_x"):  # [H, hw, hw]
        return A((0, "model"))
    if name == "lam":            # [R]
        return A((0, "model"))
    if name in ("w_z", "w_i", "w_f", "w_o"):  # xlstm [DI, DI] or [DI, H]
        return A((1, "model"), (0, "data"))
    if name == "embed":          # [V, D]
        return A((0, "model"), (1, "data"))
    if name == "lm_head":        # [D, V]
        return A((1, "model"), (0, "data"))
    if name in ("pos_embed", "enc_pos"):  # [T, D]
        return A((0, "model"), (1, "data"))
    # norms scale/bias, b_f, b_i and anything tiny: replicate
    return ()


def _shape(node) -> Tuple[int, ...]:
    return tuple(node.shape) if hasattr(node, "shape") else ()


def tree_pspecs(tree, mesh, pspec_fn) -> Any:
    def walk(path_parts, node):
        if isinstance(node, dict):
            return {k: walk(path_parts + [str(k)], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [walk(path_parts + [str(i)], v) for i, v in enumerate(node)]
            return type(node)(t) if isinstance(node, tuple) else t
        return pspec_fn("/".join(path_parts), _shape(node), mesh)

    return walk([], tree)


def _coord(mesh, axis) -> Tuple[int, int]:
    """(this rank's index, number of shards) along ``axis``, a name or a
    tuple of names (the first major)."""
    idx, n = 0, 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        idx = idx * mesh.shape[a] + mesh.coords[a]
        n *= mesh.shape[a]
    return idx, n


def local_slice(x, spec: Tuple, mesh):
    """This rank's block of ``x`` (a tensor or a numpy array) under ``spec``,
    as a view."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        idx, n = _coord(mesh, axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {axis!r} ({n})")
        size = x.shape[dim] // n
        x = x[(slice(None),) * dim + (slice(idx * size, (idx + 1) * size),)]
    return x


def shard_tree(tree, mesh, pspec_fn=param_pspec):
    """Every leaf of ``tree`` cut to this rank's block of it under
    ``pspec_fn(path, shape, mesh)`` (``mesh.coords`` gives the rank's place
    on each axis).  A cut leaf is a copy, so the full leaf can be freed; an
    uncut one is the leaf itself."""
    specs = tree_pspecs(tree, mesh, pspec_fn)

    def cut(node, spec):
        if isinstance(node, dict):
            return {k: cut(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(cut(v, s) for v, s in zip(node, spec))
        if not any(a is not None for a in spec):
            return node
        out = local_slice(node, spec, mesh)
        return out.clone() if hasattr(out, "clone") else out.copy()

    return cut(tree, specs)


# Full-DP mode: small models whose head layout defeats tensor parallelism
# (e.g. xlstm-1.3b: 4 heads vs a 16-way model axis) run pure data parallelism:
# batch shards over BOTH axes and params are FSDP over the combined axes.
FULL_DP = False


def _batch_axes(mesh):
    if FULL_DP:
        return tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def batch_pspecs(path: str, shape, mesh) -> Tuple:
    """Inputs: tokens/labels [B, S]; prefix/enc embeds [B, N, D]."""
    ba = _batch_axes(mesh)
    if not shape:
        return ()
    if shape[0] % _axis_size(mesh, ba) == 0:
        return _spec((ba, *([None] * (len(shape) - 1))))
    # batch too small (long_500k b=1): shard sequence instead where possible
    if len(shape) >= 2 and shape[1] % _axis_size(mesh, ba) == 0:
        return _spec((None, ba, *([None] * (len(shape) - 2))))
    return ()


def decode_state_pspecs(path: str, shape, mesh) -> Tuple:
    """KV caches [G, B, L, KV, hd]; recurrent states [G, B, ...]."""
    ba = _batch_axes(mesh)
    name = path.split("/")[-1]
    stk = 1 if "blocks" in path else 0

    def A(*prefs):
        return _assign(shape, mesh, [(d + stk, a) for d, a in prefs])

    if name in ("k", "v"):        # [B, L, KV, hd]
        return A((0, ba), (2, "model"), (3, "model"), (1, ba))
    if name in ("cross_k", "cross_v"):
        return A((0, ba), (2, "model"), (3, "model"))
    if name == "pos":             # [B, L]
        return A((0, ba), (1, ba))
    if name == "h":               # rglru [B, R]
        return A((0, ba), (1, "model"))
    if name == "conv":            # [B, w-1, R]
        return A((0, ba), (2, "model"))
    if name == "C":               # mlstm [B, H, hd, hd]
        return A((0, ba), (1, "model"), (2, "model"))
    if name in ("n", "m"):        # [B, H, hd] / [B, H]
        return A((0, ba), (1, "model"), (2, "model"))
    if name in ("c",):            # slstm [B, DI]
        return A((0, ba), (1, "model"))
    return ()
