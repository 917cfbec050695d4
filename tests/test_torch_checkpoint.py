"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``), and the quickstart example.

* a checkpoint written by either package loads in the other to equal
  arrays (bit for bit) and equal extras (step, global index, CIG order,
  metadata), for a float32 tree with nested dicts and lists and for a bf16
  tree;
* the file's members are the reference's bytes: the same ``param::`` /
  ``gidx::`` / ``order::`` keys and ``__meta__``, each member's ``.npy``
  bytes equal (a bf16 leaf as the reference writes JAX's bfloat16: the
  2-byte void ``<V2``, which reads back as ``|V2`` in both packages:
  ROADMAP queue C), and ``tree_from_checkpoint`` turns those back into
  ``torch.bfloat16`` of the same bits;
* ``examples/torch_quickstart.py``'s ``main`` at ``--steps 3 --device cpu``
  (loss falls, three lines printed, tokens in range).

Everything is exact: no tolerance.
"""
import importlib.util
import pathlib
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro_torch.checkpoint import checkpoint as tck

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _trees(dtype):
    """The same tree as numpy (for the reference) and as torch tensors."""
    rng = np.random.default_rng(0)
    f = rng.standard_normal
    np_tree = {
        "embed": f((6, 4)).astype(np.float32),
        "blocks": {"s0": {"attn": {"wq": f((2, 4, 2, 3)).astype(np.float32)},
                          "ln": {"scale": np.zeros((2, 4), np.float32)}}},
        "rem": [{"w": f((3,)).astype(np.float32)}, [f((2, 2)).astype(np.float32),
                                                    np.arange(5, dtype=np.int32)]],
    }
    extras = dict(step=7, global_index={"conv0": np.array([0, 2, 5], np.int64)},
                  importance_order={"conv0": np.array([5, 0, 2, 1, 3, 4], np.int64),
                                    "fc": np.arange(3, dtype=np.int32)},
                  meta={"arch": "t", "retention": 0.6})

    def jax_leaf(a):
        return jnp.asarray(a, dtype=jnp.bfloat16) if dtype == "bf16" and a.dtype == np.float32 \
            else jnp.asarray(a)

    def torch_leaf(a):
        t = torch.as_tensor(a)
        return t.bfloat16() if dtype == "bf16" and a.dtype == np.float32 else t

    def walk(t, fn):
        if isinstance(t, dict):
            return {k: walk(v, fn) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, fn) for v in t]
        return fn(t)

    return walk(np_tree, jax_leaf), walk(np_tree, torch_leaf), extras


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and a.dtype.kind in "Vf" else a


def _assert_same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_checkpoints_cross_load_with_the_same_bytes(dtype, tmp_path):
    jtree, ttree, extras = _trees(dtype)
    jck.save_checkpoint(str(tmp_path / "ref"), jtree, **extras)
    tck.save_checkpoint(str(tmp_path / "port"), ttree, **extras)
    assert _members(tmp_path / "ref.npz") == _members(tmp_path / "port.npz")
    if dtype == "bf16":
        with zipfile.ZipFile(tmp_path / "port.npz") as z:
            assert b"'descr': '<V2'" in z.read("param::embed.npy")
    ref_loaded = jck.load_checkpoint(str(tmp_path / "port"))      # the suffix added on load
    port_loaded = tck.load_checkpoint(str(tmp_path / "ref"))
    for params, ex in (ref_loaded, port_loaded):
        _assert_same(params, jck.load_checkpoint(str(tmp_path / "ref.npz"))[0])
        assert ex["step"] == 7 and ex["meta"] == extras["meta"]
        for key in ("global_index", "importance_order"):
            assert ex[key].keys() == extras[key].keys()
            for k, v in extras[key].items():
                assert ex[key][k].dtype == v.dtype and np.array_equal(ex[key][k], v)
    assert isinstance(port_loaded[0]["rem"], list) and isinstance(port_loaded[0]["rem"][1], list)
    back = tck.tree_from_checkpoint(port_loaded[0], like=ttree)
    flat_t = [ttree["embed"], ttree["rem"][1][0], ttree["rem"][1][1]]
    flat_b = [back["embed"], back["rem"][1][0], back["rem"][1][1]]
    for a, b in zip(flat_t, flat_b):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16) if a.element_size() == 2 else a,
                                                  b.view(torch.int16) if b.element_size() == 2 else b)
    if dtype == "bf16":
        assert port_loaded[0]["embed"].dtype == np.dtype("|V2")   # the reference's own deviation
        with pytest.raises(ValueError, match="bfloat16"):
            tck.tree_from_checkpoint(port_loaded[0], like=_trees("f32")[1])


def test_quickstart_main_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location("torch_quickstart",
                                                  ROOT / "examples" / "torch_quickstart.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--steps", "3", "--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[quickstart]")]
    assert len(lines) == 3 and "internlm2-1.8b (reduced)" in lines[0]
    assert out["losses"][-1] < out["losses"][0] and len(out["losses"]) == 3
    gen = out["generated"]
    assert tuple(gen.shape) == (2, 8) and gen.device.type == "cpu"
    assert bool(((gen >= 0) & (gen < out["sub_cfg"].vocab_size)).all())
    assert out["sub_cfg"].retention == 0.6
