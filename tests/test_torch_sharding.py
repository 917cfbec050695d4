"""The port's LLM sharding rules (``repro_torch.sharding.specs``) and model
meshes (``repro_torch.launch.mesh``) against the reference's.

* ``param_pspec`` through ``tree_pspecs`` gives the reference's spec for
  every parameter of every arch at full size (the reference's abstract
  ``init_params`` tree), on the single-pod and multi-pod production meshes
  (the reference tests' ``FakeMesh`` and the port's
  ``make_production_mesh``), also in ``FULL_DP`` mode;
* ``decode_state_pspecs`` on every arch's decode state at ``decode_32k``
  and ``long_500k``, ``batch_pspecs`` on every input of every ``SHAPES``
  entry (the sequence fallback at batch 1), ``_assign``'s divisibility;
* the port's shape-only init (``init_params(SHAPE_ONLY, cfg)``): the tree
  paths, shapes and dtypes of the reference's ``jax.eval_shape`` of its
  init, exact, for every arch at full size and through the dry-run's
  ``prepare_config`` (bf16, padded vocab, retention 0.6 and 0.3, the
  ``windowed`` variant, decode's learned positions), every leaf on ``meta``;
* ``make_local_mesh``'s shrink rule (``data * model`` over the world
  becomes ``(world, 1)``) on a one-rank gloo group, ``current_mesh`` under
  ``with mesh:``, the production record and ``HARDWARE``; under a model
  axis, ``lm_loss`` refuses to train and ``moe_fwd`` refuses a shape
  record.

A spec is compared as ``tuple(PartitionSpec)``: exact.  ``shard_tree``'s
blocks on real multi-rank meshes are held in ``tests/test_torch_moe_ep.py``.
"""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest

from repro.configs import SHAPES, get_config, list_archs
from repro.launch import mesh as jmesh
from repro.models import transformer as JT
from repro.sharding import specs as js
import torch

from repro_torch.configs import smoke_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.sharding import specs as ts


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread beats a pool of them,
    which only contends with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """Mesh stand-in exposing only .shape, as the reference's tests."""

    def __init__(self, **axes):
        self.shape = dict(axes)


MESHES = {"single": FakeMesh(data=16, model=16), "multi": FakeMesh(pod=2, data=16, model=16)}


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    cfg = get_config(arch)
    params = jax.eval_shape(lambda: JT.init_params(jax.random.key(0), cfg))
    enc = 1500 if cfg.encoder_layers else 0
    states = {n: jax.eval_shape(lambda b=SHAPES[n].global_batch, L=SHAPES[n].seq_len:
                                JT.init_decode_state(cfg, b, L, enc_len=enc))
              for n in ("decode_32k", "long_500k")}
    return params, states


def _ref(tree, mesh, fn):
    return jax.tree.map(tuple, js.tree_pspecs(tree, mesh, fn),
                        is_leaf=lambda x: type(x).__name__ == "PartitionSpec")


def _equal(port, ref, path=""):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _equal(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _equal(a, b, f"{path}/{i}")
    else:
        assert port == ref, (path, port, ref)


@pytest.mark.parametrize("arch", list_archs())
def test_param_and_decode_state_specs_equal_the_reference(arch, monkeypatch):
    params, states = _abstract(arch)
    checked = 0
    for name, mesh in MESHES.items():
        prod = tmesh.make_production_mesh(multi_pod=name == "multi")
        assert prod.shape == mesh.shape
        for full_dp in (False, True):
            monkeypatch.setattr(js, "FULL_DP", full_dp)
            monkeypatch.setattr(ts, "FULL_DP", full_dp)
            ref = _ref(params, mesh, js.param_pspec)
            _equal(ts.tree_pspecs(params, mesh, ts.param_pspec), ref)
            _equal(ts.tree_pspecs(params, prod, ts.param_pspec), ref)
            for st in states.values():
                _equal(ts.tree_pspecs(st, prod, ts.decode_state_pspecs),
                       _ref(st, mesh, js.decode_state_pspecs))
            checked += 1
    # the rules shard something of every arch on the production mesh
    monkeypatch.setattr(ts, "FULL_DP", False)
    flat = jax.tree.leaves(ts.tree_pspecs(params, MESHES["single"], ts.param_pspec),
                           is_leaf=lambda x: isinstance(x, tuple))
    assert checked == 4 and any(any(a is not None for a in s) for s in flat)
    # a mesh without a data or model axis replicates everything
    assert ts.param_pspec("blocks/s0/attn/wq", (4, 64, 16, 8), FakeMesh(fleet=4)) == ()


# one prepared config an arch, together covering each of prepare_config's changes
PREPARED = {
    "internlm2-1.8b": dict(shape_name="train_4k"),                 # bf16, vocab padded
    "llama4-maverick-400b-a17b": dict(shape_name="train_4k", retention=0.6),
    "recurrentgemma-9b": dict(shape_name="prefill_32k", retention=0.3),
    "granite-moe-1b-a400m": dict(shape_name="long_500k", variant="windowed"),
    "whisper-small": dict(shape_name="decode_32k", retention=0.6),  # max_position
}


def _prepared(arch):
    jax.devices()       # before the reference's dry-run sets its device flag
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as JD

    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    from repro_torch.launch import dryrun as TD

    kw = PREPARED[arch]
    return TD.prepare_config(arch, **kw), JD.prepare_config(arch, **kw)


def _same_tree(port, ref, path="root"):
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            _same_tree(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _same_tree(a, b, f"{path}/{i}")
    else:
        assert port.device.type == "meta", path
        assert tuple(port.shape) == tuple(ref.shape), (path, tuple(port.shape), ref.shape)
        assert str(port.dtype).replace("torch.", "") == ref.dtype.name, (path, port.dtype)


@pytest.mark.parametrize("arch", list_archs())
def test_shape_only_init_equals_the_reference_tree(arch):
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.models.layers import SHAPE_ONLY

    params, _ = _abstract(arch)
    _same_tree(TT.init_params(SHAPE_ONLY, t_get_config(arch)), params)
    if arch in PREPARED:
        tc, jc = _prepared(arch)
        _same_tree(TT.init_params(SHAPE_ONLY, tc),
                   jax.eval_shape(lambda: JT.init_params(jax.random.key(0), jc)))


@pytest.mark.parametrize("name", list(MESHES))
def test_batch_specs_equal_the_reference(name):
    mesh = MESHES[name]
    for arch in ("internlm2-1.8b", "whisper-small", "internvl2-76b"):
        cfg = get_config(arch)
        for shp in SHAPES.values():
            B, S = shp.global_batch, shp.seq_len
            shapes = {"tokens": (B, S - cfg.num_prefix_embeds), "token": (B,),
                      "prefix_embeds": (B, cfg.num_prefix_embeds, cfg.d_model),
                      "enc_embeds": (B, 1500, cfg.d_model), "scalar": ()}
            for path, shape in shapes.items():
                assert ts.batch_pspecs(path, shape, mesh) == tuple(js.batch_pspecs(path, shape, mesh))
    # long_500k: batch 1 shards the sequence instead
    want = (None, ("pod", "data")) if name == "multi" else (None, "data")
    assert ts.batch_pspecs("tokens", (1, 524_288), mesh) == want
    assert ts.batch_pspecs("tokens", (1, 7), mesh) == ()


def test_assign_is_divisibility_checked():
    mesh = MESHES["single"]
    cases = [((512, 8, 64), [(1, "model"), (0, "data")]),        # 8 heads on a 16-way axis
             ((512, 32, 64), [(1, "model"), (2, "model"), (0, "data")]),
             ((512, 8, 64), [(1, "model"), (2, "model"), (0, "data")]),
             ((24, 5120, 128), [(-1, "model"), (1, "data"), (0, "data")]),
             ((3, 7), [(0, "model"), (1, ("data", "model"))]),
             ((256, 4), [(0, ("data", "model")), (1, "model")])]
    for shape, prefs in cases:
        assert ts._assign(shape, mesh, prefs) == tuple(js._assign(shape, mesh, prefs))
    assert ts._assign((512, 8, 64), mesh, [(1, "model"), (0, "data")]) == ("data", None, None)


def test_local_mesh_shrinks_and_sets_current_mesh():
    assert ts.current_mesh() is None
    with tmesh.fleet_group(device="cpu"):
        m = tmesh.make_local_mesh(2, 2)          # 4 > 1 rank: becomes (1, 1)
        assert m.shape == {"data": 1, "model": 1} and m.coords == {"data": 0, "model": 0}
        assert m.transport == "gloo" and m.device.type == "cpu"
        with m:
            assert ts.current_mesh() is m
            with tmesh.make_production_mesh() as prod:
                assert ts.current_mesh() is prod
            assert ts.current_mesh() is m
        with pytest.raises(ValueError, match="does not run on"):
            tmesh.make_local_mesh(1, 1, device="meta")
    assert ts.current_mesh() is None
    with pytest.raises(RuntimeError, match="running torch.distributed group"):
        tmesh.make_local_mesh(1, 1)
    # the reference's rule on its own devices
    n = len(jax.devices())
    assert dict(jmesh.make_local_mesh(n + 1, 2).shape) == {"data": n, "model": 1}


def test_production_record_and_hardware():
    single, multi = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.axis_names == ("pod", "data", "model")
    hw = tmesh.HARDWARE
    assert hw["name"] == "NVIDIA H100 80GB HBM3"
    assert (hw["peak_flops_bf16"], hw["hbm_bandwidth"], hw["hbm_bytes"], hw["nvlink_bandwidth"]) == (
        989e12, 3.35e12, 80e9, 450e9)
    assert ts.constrain(np.ones(3), [(0, "batch")]).sum() == 3


def test_model_axis_refusals_name_what_is_not_ported():
    cfg = smoke_config("granite-moe-1b-a400m")
    params = TT.init_params(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long)}
    x = torch.zeros(1, 4, cfg.d_model)
    with tmesh.make_production_mesh():
        with pytest.raises(NotImplementedError, match="A8"):
            TT.lm_loss(params, cfg, batch)
        # 16 experts divide over the record's 16-way model axis
        spec = dataclasses.replace(TT._moe_spec(cfg), num_experts=16)
        with pytest.raises(ValueError, match="shape record"):
            tmoe.moe_fwd(tmoe.init_moe(torch.Generator().manual_seed(1), spec), spec, x)
    # outside a mesh both run
    assert torch.isfinite(TT.lm_loss(params, cfg, batch))
