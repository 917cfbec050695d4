"""Checkpointing: parameter tree <-> ``.npz`` with global-index + config
metadata (port of ``repro/checkpoint/checkpoint.py``).

AdaptCL checkpoints carry the worker's global index I_w (unit ids per layer)
so a restored sub-model can be re-embedded into base coordinates; the server
checkpoint carries the CIG importance order so pruning stays constant across
restarts (recomputing the order after a restart would silently break the
paper's principle).

The file is the reference's, byte for byte: one array per leaf under
``param::<path>`` (``::`` joins the path, ``#i`` names a list item),
``gidx::<layer>`` and ``order::<layer>`` for the extras, and the JSON
metadata (``step`` first) as a uint8 array under ``__meta__``; ``.npz`` is
added to a path on load.  So a checkpoint written by either package loads
in the other.

``save_checkpoint`` takes a tree of torch tensors (any device) or of numpy
arrays.  A ``torch.bfloat16`` leaf is written as the reference writes
JAX's bfloat16 (the ``ml_dtypes`` type, whose ``.npy`` header says
``'descr': '<V2'``): the header written as numpy writes it for that type,
then the leaf's raw bits, so ``ml_dtypes`` is not needed (numpy's own
2-byte void would say ``|V2``).  The archive is written as ``np.savez``
writes it (stored, zip64 members).  ``load_checkpoint`` returns what the
reference returns: numpy arrays, a bf16 leaf as a ``|V2`` void array of its
bits (``tree_from_checkpoint`` turns those back into ``torch.bfloat16``).
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "tree_from_checkpoint"]

_SEP = "::"


class _Bf16Bits:
    """A bf16 leaf's bits (uint16), written with the ``<V2`` header."""

    def __init__(self, bits: np.ndarray):
        self.bits = np.ascontiguousarray(bits)


def _leaf(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _Bf16Bits(t.view(torch.uint16).numpy())
        return t.numpy()
    return np.asarray(x)


def _savez(path: str, payload: Dict[str, Any]) -> None:
    """``np.savez(path, **payload)``, with ``_Bf16Bits`` members written
    under the header numpy gives JAX's bfloat16."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as z:
        for key, val in payload.items():
            with z.open(key + ".npy", "w", force_zip64=True) as fid:
                if isinstance(val, _Bf16Bits):
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": "<V2", "fortran_order": False, "shape": val.bits.shape})
                    fid.write(val.bits.tobytes())
                else:
                    np.lib.format.write_array(fid, np.asanyarray(val), allow_pickle=False)


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix[: -len(_SEP)]] = _leaf(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [fix(node[f"#{i}"]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def save_checkpoint(
    path: str,
    params,
    *,
    step: int = 0,
    global_index: Optional[Dict[str, Any]] = None,
    importance_order: Optional[Dict[str, Any]] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(params)
    payload = {f"param{_SEP}{k}": v for k, v in flat.items()}
    if global_index:
        payload.update({f"gidx{_SEP}{k}": _leaf(v) for k, v in global_index.items()})
    if importance_order:
        payload.update({f"order{_SEP}{k}": _leaf(v) for k, v in importance_order.items()})
    payload["__meta__"] = np.frombuffer(
        json.dumps({"step": step, **(meta or {})}).encode(), dtype=np.uint8
    )
    _savez(path, payload)


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Returns (params, extras) where extras has step/global_index/order/meta."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = np.load(path, allow_pickle=False)
    flat_params, gidx, order = {}, {}, {}
    meta: Dict[str, Any] = {}
    for key in z.files:
        if key == "__meta__":
            meta = json.loads(z[key].tobytes().decode())
        elif key.startswith(f"param{_SEP}"):
            flat_params[key[len(f"param{_SEP}") :]] = z[key]
        elif key.startswith(f"gidx{_SEP}"):
            gidx[key[len(f"gidx{_SEP}") :]] = z[key]
        elif key.startswith(f"order{_SEP}"):
            order[key[len(f"order{_SEP}") :]] = z[key]
    extras = {"step": meta.pop("step", 0), "global_index": gidx, "importance_order": order, "meta": meta}
    return _unflatten(flat_params), extras


def tree_from_checkpoint(tree, device="cpu", like=None):
    """A loaded params tree as tensors on ``device``.  A 2-byte void leaf
    (how a bf16 leaf comes back) becomes ``torch.bfloat16`` of its bits;
    every other leaf keeps its dtype.  With ``like``, a tree of the same
    structure, each leaf's dtype is checked against it."""
    if isinstance(tree, dict):
        return {k: tree_from_checkpoint(v, device, None if like is None else like[k])
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_from_checkpoint(v, device, None if like is None else like[i])
                for i, v in enumerate(tree)]
    a = np.asarray(tree)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if like is not None and t.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf {t.dtype} where the model has {like.dtype}")
    return t.to(device)
