"""The port's collaborative round on the mesh (``core/collab.py``) against
the JAX package.

* at one rank: ``collab_round`` equals JAX ``collab_round`` on a one-device
  ``data`` mesh (the inputs of ``tests/test_collab_mesh.py:21-52``), pruned
  coordinates exact zeros, ``make_worker_masks`` equal to the reference's,
  and the round's aggregation is one backend collective (a spy on
  ``torch.distributed.all_gather``);
* at two gloo ranks, one worker each with its own mask and shard: every
  rank returns the same global, equal to the host path (each worker's
  masked local SGD, then ``aggregation.aggregate_by_worker`` of the
  submissions in float64), again with one collective a round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core import collab as jcollab
from repro.core.masks import UnitLayer as JLayer, UnitSpace as JSpace
from repro.core.masks import full_index as j_full_index, prune_to_budget as j_prune
from repro_torch.core import collab as tcollab
from repro_torch.core.aggregation import aggregate_by_worker, extract_subparams
from repro_torch.core.masks import UnitLayer, UnitSpace, full_index, prune_to_budget
from repro_torch.launch import mesh as tmesh

SPACE = UnitSpace(layers=(UnitLayer("u", 8, 4),), fixed_params=6)
J_SPACE = JSpace(layers=(JLayer("u", 8, 4),), fixed_params=6)
UNIT_MAP = {"w": [("u", 1)], "b": [("u", 0)]}
LR, STEPS, BATCH = 0.1, 2, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_loss(params, x, y):
    logits = x @ params["w"] + params["b"]
    logp = jax.nn.log_softmax(logits)
    return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()


def inputs(workers):
    """The reference test's base params and data, with ``workers`` shards
    of 64 images and worker ``w`` pruned at rate ``0.4 + 0.1 w``."""
    rng = np.random.default_rng(0)
    base = {"w": rng.normal(size=(4, 8)).astype(np.float32), "b": np.zeros((8,), np.float32)}
    scores = {"u": np.arange(8, dtype=np.float64)}
    indices = [prune_to_budget(full_index(SPACE), scores, 0.4 + 0.1 * w, SPACE)
               for w in range(workers)]
    x = rng.normal(size=(64 * workers, 4)).astype(np.float32)
    y = rng.integers(0, 8, 64 * workers).astype(np.int64)
    return base, indices, x, y


def test_collab_round_matches_jax_at_one_rank(monkeypatch):
    base, (idx,), x, y = inputs(1)
    shapes = {k: v.shape for k, v in base.items()}
    j_idx = j_prune(j_full_index(J_SPACE), {"u": np.arange(8, dtype=np.float64)}, 0.4, J_SPACE)
    assert {k: list(v) for k, v in j_idx.items()} == {k: list(v) for k, v in idx.items()}
    j_masks = jcollab.make_worker_masks([j_idx], UNIT_MAP, shapes)
    masks = tcollab.make_worker_masks([idx], UNIT_MAP, shapes)
    for k in base:
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(j_masks[k]))
    ref = jcollab.collab_round(
        _j_loss, {k: jnp.asarray(v) for k, v in base.items()}, j_masks, jnp.asarray(x),
        jnp.asarray(y, jnp.int32), jax.make_mesh((1,), ("data",)), lr=LR, steps=STEPS,
        batch_size=BATCH)
    calls = []
    real = dist.all_gather
    monkeypatch.setattr(dist, "all_gather", lambda *a, **kw: (calls.append(1), real(*a, **kw))[1])
    with tmesh.fleet_group(device="cpu"):
        mesh = tmesh.make_fleet_mesh(1, axis="data")
        calls.clear()
        out = tcollab.collab_round(
            tcollab.linear_softmax_loss, {k: torch.as_tensor(v) for k, v in base.items()},
            masks, torch.as_tensor(x), torch.as_tensor(y), mesh, lr=LR, steps=STEPS,
            batch_size=BATCH)
    assert len(calls) == 1
    for k in base:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-6)
    pruned = np.setdiff1d(np.arange(8), np.asarray(idx["u"]))
    assert np.abs(out["w"].numpy()[:, pruned]).max() == 0.0
    assert np.abs(out["b"].numpy()[pruned]).max() == 0.0


def test_collab_round_refuses_a_mesh_without_its_axis():
    base, (idx,), x, y = inputs(1)
    masks = tcollab.make_worker_masks([idx], UNIT_MAP, {k: v.shape for k, v in base.items()})

    class _Mesh:
        shape = {"fleet": 1}

    with pytest.raises(ValueError, match="no 'data' axis"):
        tcollab.collab_round(tcollab.linear_softmax_loss,
                             {k: torch.as_tensor(v) for k, v in base.items()}, masks,
                             torch.as_tensor(x), torch.as_tensor(y), _Mesh())


def test_collab_round_on_two_ranks_is_host_aggregation():
    base, indices, x, y = inputs(2)
    shapes = {k: v.shape for k, v in base.items()}
    masks = {k: v.numpy() for k, v in tcollab.make_worker_masks(indices, UNIT_MAP, shapes).items()}
    outs = tmesh.run_ranks(2, tmesh.run_cases,
                           ([("round", "collab", (base, masks, x, y, LR, STEPS, BATCH))],),
                           axis="data")
    for o in outs[1:]:
        for k in base:
            assert np.array_equal(o["round"][k], outs[0]["round"][k])
    assert [o["_calls"]["round"]["all_gather"] for o in outs] == [1, 1]
    subs = []
    for w, idx in enumerate(indices):
        m = {k: torch.as_tensor(v[w]) for k, v in masks.items()}
        theta = tcollab.local_sgd_steps(
            lambda p, xb, yb: tcollab.linear_softmax_loss({k: p[k] * m[k] for k in p}, xb, yb),
            {k: torch.as_tensor(v) * m[k] for k, v in base.items()},
            torch.as_tensor(x[64 * w : 64 * (w + 1)]), torch.as_tensor(y[64 * w : 64 * (w + 1)]),
            lr=LR, steps=STEPS, batch_size=BATCH)
        theta = {k: (v * m[k]).detach() for k, v in theta.items()}
        subs.append((extract_subparams(theta, idx, UNIT_MAP), idx))
    host = aggregate_by_worker(subs, UNIT_MAP, shapes)
    for k in base:
        np.testing.assert_allclose(outs[0]["round"][k], host[k].numpy(), rtol=0, atol=1e-6)
