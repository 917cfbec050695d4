"""The fused engine's device pieces on the port against the JAX package's.

On the same seeded numpy inputs (the unit space of ``tests/test_fused.py``'s
TINY VGG, built from the JAX init):

* ``masks.prune_order`` / ``prune_budget_units`` equal to the reference's;
  ``prune_presence_rows`` and ``regrow_presence_rows`` (closed-form walks
  here, ``lax.scan`` walks there) on the golden cases of
  ``tests/test_fused.py`` (random scores, massive ties, ``min_units``
  skips, zero budgets, chained prunes) and on multi-row stacks with
  different orders and budgets per row: exact, and equal to the host greedy;
* ``fleet.masks_from_presence`` and ``gl_factors_from_counts``: exact;
  ``fleet.refetch_rows``: exact;
* ``importance.{STATIC,DEVICE,CIG}_METHODS`` equal to the reference's sets;
* the device importances: l1 and taylor ``[W, U]`` scores within 1e-5 of the
  reference's fused-engine scorer, and the device orders (``device_order``
  against ``jnp.lexsort``) identical on ties and -inf slots;
* float32 stacked by-worker / by-unit aggregation within 1e-6;
* ``dgc_compress_dev`` against ``dgc_compress_jnp`` and the port's host
  ``_dgc_compress_stacked``: identical keep sets and kept counts (ties,
  masks, fully masked rows, gated rows), committed values and residuals
  within 1e-6;
* ``async_commit_dev`` against ``async_commit_jnp`` for the three methods
  over a scripted commit sequence, within 1e-6;
* ``split_time_keys`` and ``async_pop_perm``: identical permutations, ties
  and sub-float32 residuals included, plus the reference's goldens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import fleet as jfleet
from repro.core import fused as jfused
from repro.core import importance as jimp
from repro.core import masks as jmasks
from repro.core.worker import LocalTrainer as JTrainer
from repro.models import cnn as jcnn
from repro_torch.core import aggregation as tagg
from repro_torch.core import fleet as tfleet
from repro_torch.core import fused as tfused
from repro_torch.core import importance as timp
from repro_torch.core import masks as tmasks
from repro_torch.core import simulation as tsim
from repro_torch.core.worker import LocalTrainer as TTrainer
from repro_torch.models import cnn as tcnn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PLAN = [8, "M", 16]


def setup():
    jcfg = jcnn.vgg_config("vgg_tiny_fused", PLAN, num_classes=4, image_size=8)
    tcfg = tcnn.vgg_config("vgg_tiny_fused", PLAN, num_classes=4, image_size=8)
    init = {k: np.asarray(v) for k, v in jcnn.init_cnn(jax.random.PRNGKey(0), jcfg).items()}
    jspace, jmap = jcnn.build_unit_space(jcfg, init)
    tspace, tmap = tcnn.build_unit_space(tcfg, {k: torch.tensor(v) for k, v in init.items()})
    return dict(jcfg=jcfg, tcfg=tcfg, init=init, jspace=jspace, jmap=jmap, tspace=tspace,
                tmap=tmap, jflat=jmasks.flatten_unit_space(jspace),
                tflat=tmasks.flatten_unit_space(tspace),
                shapes={k: tuple(v.shape) for k, v in init.items()})


S = setup()


def _scores(rng, case):
    if case == "floor":
        # the first layer's units all score lowest: the walk takes that
        # layer down to min_units, skips the rest of it and goes on
        first = S["tspace"].layers[0].name
        return {l.name: (-100.0 - np.arange(l.num_units) if l.name == first
                         else rng.normal(size=l.num_units)) for l in S["tspace"].layers}
    if case == "ties":
        return {l.name: rng.integers(0, 3, l.num_units).astype(np.float64)
                for l in S["tspace"].layers}
    return {l.name: rng.normal(size=l.num_units) for l in S["tspace"].layers}


def _index_equal(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# prune and regrow greedies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,rates", [
    ("random", [0.2, 0.4, 0.7]), ("ties", [0.3, 0.55]), ("minunits", [0.97]), ("zero", [0.0]),
    ("floor", [0.8]),
])
def test_device_prune_matches_jax_and_host_golden(case, rates):
    rng = np.random.default_rng(3)
    scores = _scores(rng, case)
    tspace, jspace, tflat, jflat = S["tspace"], S["jspace"], S["tflat"], S["jflat"]
    index = tmasks.full_index(tspace)
    for rate in rates:
        host = tmasks.prune_to_budget(index, scores, rate, tspace)
        order = tmasks.prune_order(scores, tflat)
        assert np.array_equal(order, jmasks.prune_order(scores, jflat))
        budget = tmasks.prune_budget_units(index, rate, tspace)
        assert budget == jmasks.prune_budget_units(index, rate, jspace)
        pres = tmasks.presence_from_index(index, tflat)[None]
        out = tmasks.prune_presence_rows(torch.tensor(pres), torch.tensor(order[None]),
                                         torch.tensor([budget]), tflat).numpy()[0]
        ref = np.asarray(jmasks.prune_presence_rows(pres, order[None],
                                                    np.asarray([budget], np.int32), jflat))[0]
        assert np.array_equal(out, ref), f"{case} rate={rate}"
        assert _index_equal(tmasks.index_from_presence(out, tflat), host)
        if case == "floor":
            first = tspace.layers[0]
            assert len(host[first.name]) == first.min_units
            assert any(len(host[l.name]) < l.num_units for l in tspace.layers[1:])
        index = host     # chained prunes cover nested indices


def test_device_prune_rows_differ_per_worker():
    """Five rows, each with its own presence, order and budget (one zero):
    the rows are walked independently."""
    rng = np.random.default_rng(9)
    tspace, tflat, jflat = S["tspace"], S["tflat"], S["jflat"]
    pres, orders, budgets = [], [], []
    for w in range(5):
        scores = _scores(rng, "ties" if w % 2 else "random")
        idx = tmasks.prune_to_budget(tmasks.full_index(tspace), _scores(rng, "random"),
                                     0.1 * w, tspace)
        pres.append(tmasks.presence_from_index(idx, tflat))
        orders.append(tmasks.prune_order(scores, tflat))
        budgets.append(0 if w == 2 else tmasks.prune_budget_units(idx, 0.15 + 0.1 * w, tspace))
    pres, orders = np.stack(pres), np.stack(orders)
    budgets = np.asarray(budgets, np.int32)
    out = tmasks.prune_presence_rows(torch.tensor(pres), torch.tensor(orders),
                                     torch.tensor(budgets), tflat).numpy()
    ref = np.asarray(jmasks.prune_presence_rows(pres, orders, budgets, jflat))
    assert np.array_equal(out, ref)
    assert np.array_equal(out[2], pres[2])
    assert (out.sum(1) < pres.sum(1))[[0, 1, 3, 4]].all()


@pytest.mark.parametrize("budget", [0, 3, 17, 10**6])
def test_device_regrow_matches_jax_and_host_golden(budget):
    rng = np.random.default_rng(7)
    tspace, tflat, jflat = S["tspace"], S["tflat"], S["jflat"]
    idx = tmasks.prune_to_budget(tmasks.full_index(tspace), _scores(rng, "random"), 0.5, tspace)
    grow = _scores(rng, "ties")
    order = tmasks.grow_order(grow, tflat)
    host = tmasks.regrow_index(idx, grow, budget, tspace)
    pres = tmasks.presence_from_index(idx, tflat)[None]
    out = tmasks.regrow_presence_rows(torch.tensor(pres), torch.tensor(order[None]),
                                      torch.tensor([budget]), tflat).numpy()[0]
    ref = np.asarray(jmasks.regrow_presence_rows(pres, order[None],
                                                 np.asarray([budget], np.int32), jflat))[0]
    assert np.array_equal(out, ref)
    assert _index_equal(tmasks.index_from_presence(out, tflat), host)


# ---------------------------------------------------------------------------
# fleet pieces
# ---------------------------------------------------------------------------

def _presence(rng, W=4):
    p = (rng.random((W, S["tflat"].num_units)) < 0.6).astype(np.float32)
    p[0] = 1.0
    return p


def test_masks_from_presence_and_gl_factors_exact():
    rng = np.random.default_rng(1)
    pres = _presence(rng)
    tm = tfleet.masks_from_presence(torch.tensor(pres), S["tflat"], S["tmap"], S["shapes"])
    jm = jfleet.masks_from_presence(jnp.asarray(pres), S["jflat"], S["jmap"], S["shapes"])
    assert tm.keys() == jm.keys()
    for k in jm:
        assert tm[k].dtype == torch.float32 and np.array_equal(tm[k].numpy(), np.asarray(jm[k]))
    counts = {name: pres[:, int(off):int(off + sz)].sum(1)
              for name, off, sz in zip(S["tflat"].names, S["tflat"].offsets, S["tflat"].sizes)}
    tg = tfleet.gl_factors_from_counts({k: torch.tensor(v) for k, v in counts.items()},
                                       S["tmap"], S["shapes"])
    jg = jfleet.gl_factors_from_counts({k: jnp.asarray(v) for k, v in counts.items()},
                                       S["jmap"], S["shapes"])
    assert tg.keys() == jg.keys()
    for k in jg:
        assert np.array_equal(tg[k].numpy(), np.asarray(jg[k])), k
    # the full row's factors are the host shape-derived ones
    from repro_torch.optim.group_lasso import group_size_sqrt_from_shapes
    host = group_size_sqrt_from_shapes(S["shapes"], S["tmap"])
    for k, v in host.items():
        assert tg[k][0].item() == pytest.approx(v, rel=1e-6)


def test_refetch_rows_exact():
    rng = np.random.default_rng(2)
    fetched = {k: rng.normal(size=(5,) + s).astype(np.float32) for k, s in S["shapes"].items()}
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in S["shapes"].items()}
    mask = np.asarray([0, 1, 0, 1, 1], np.float32)
    out = tfleet.refetch_rows({k: torch.tensor(v) for k, v in fetched.items()},
                              torch.tensor(mask), {k: torch.tensor(v) for k, v in g.items()})
    ref = jfleet.refetch_rows_jnp({k: jnp.asarray(v) for k, v in fetched.items()},
                                  jnp.asarray(mask), {k: jnp.asarray(v) for k, v in g.items()})
    for k in ref:
        assert np.array_equal(out[k].numpy(), np.asarray(ref[k]))
        assert np.array_equal(out[k][1].numpy(), g[k]) and np.array_equal(out[k][0].numpy(),
                                                                           fetched[k][0])


# ---------------------------------------------------------------------------
# device importances and their orders
# ---------------------------------------------------------------------------

def test_importance_method_sets_equal():
    """Which criteria the fused engine orders on the host and which it
    scores on the device: the reference's sets."""
    assert timp.STATIC_METHODS == jimp.STATIC_METHODS
    assert timp.DEVICE_METHODS == jimp.DEVICE_METHODS
    assert timp.CIG_METHODS == jimp.CIG_METHODS
    assert set(timp.METHODS) - timp.STATIC_METHODS - timp.DEVICE_METHODS == {"fpgm", "hrank"}


def _jax_device_scores(importance, params, masks, presence, xs, ys, sizes):
    """The reference fused engine's scorer (``core/fused.py:261-307``)
    applied with its own functions."""
    unit_map, names = S["jmap"], S["jflat"].names
    if importance == "l1":
        sq = {}
        for path, entries in unit_map.items():
            arr = params.get(path)
            if arr is None:
                continue
            for lname, axis in entries:
                axes = tuple(i for i in range(arr.ndim) if i not in (0, 1 + axis))
                s = jnp.sum(jnp.square(arr.astype(jnp.float32)), axis=axes)
                sq[lname] = sq.get(lname, 0.0) + s
        norms = {k: jnp.sqrt(jnp.maximum(v, 1e-12)) for k, v in sq.items()}
        return jimp.l1_scores_jnp(norms, names, presence)
    trainer = JTrainer(S["jcfg"], compute="dense")
    nb = min(64, xs.shape[1])
    xb, yb = xs[:, :nb], ys[:, :nb]
    wv = (jnp.arange(nb)[None, :] < jnp.minimum(sizes, nb)[:, None]).astype(jnp.float32)

    def ce_one(q, mask, x, y, v):
        qm = jax.tree.map(lambda w, m: w * m, q, mask)
        logp = jax.nn.log_softmax(trainer._masked_logits(qm, mask, x))
        pick = jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return -(pick * v).sum() / jnp.maximum(v.sum(), 1.0)

    grads = jax.vmap(lambda q, m, x, y, v: jax.grad(ce_one)(q, m, x, y, v))(
        params, masks, xb, yb, wv)
    gw = {}
    for path, entries in unit_map.items():
        if path not in grads:
            continue
        for lname, axis in entries:
            g, w_ = grads[path], params[path]
            axes = tuple(i for i in range(g.ndim) if i not in (0, 1 + axis))
            gw[lname] = gw.get(lname, 0.0) + jnp.abs(jnp.sum(g * w_, axis=axes))
    return jimp.taylor_scores_jnp(gw, names, presence)


@pytest.mark.parametrize("importance", ["l1", "taylor"])
def test_device_scores_and_orders_match_jax(importance):
    rng = np.random.default_rng(4)
    W = 4
    pres = _presence(rng, W)
    masks = {k: np.asarray(v) for k, v in jfleet.masks_from_presence(
        jnp.asarray(pres), S["jflat"], S["jmap"], S["shapes"]).items()}
    params = {k: (np.broadcast_to(v, (W,) + v.shape)
                  + 0.05 * rng.normal(size=(W,) + v.shape)).astype(np.float32) * masks[k]
              for k, v in S["init"].items()}
    sizes = np.asarray([40, 80, 64, 20], np.int64)
    xs = rng.normal(size=(W, 80, 8, 8, 3)).astype(np.float32)
    ys = rng.integers(0, 4, size=(W, 80)).astype(np.int64)
    ref = np.asarray(_jax_device_scores(
        importance, {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in masks.items()}, jnp.asarray(pres), jnp.asarray(xs),
        jnp.asarray(ys.astype(np.int32)), jnp.asarray(sizes.astype(np.int32))))
    chunk = tfused._SyncChunk(TTrainer(S["tcfg"], compute="dense"), S["tmap"], S["shapes"],
                              S["tflat"], 0.0, by_unit=False, importance=importance,
                              resident_momentum=False, has_phase_b=False, dgc_sparsity=0.0,
                              device="cpu")
    tp = {k: torch.tensor(v) for k, v in params.items()}
    tm = {k: torch.tensor(v) for k, v in masks.items()}
    out = chunk.device_scores(tp, tm, torch.tensor(pres), torch.tensor(xs), torch.tensor(ys),
                              torch.tensor(sizes)).numpy()
    assert out.dtype == np.float32
    assert np.array_equal(np.isinf(out), pres == 0) and np.array_equal(np.isinf(ref), pres == 0)
    live = pres > 0
    np.testing.assert_allclose(out[live], ref[live], rtol=1e-5, atol=1e-5)
    # orders on the reference's own scores: identical to jnp.lexsort
    tiebreak = S["tflat"].tiebreak
    want = np.asarray(jax.vmap(lambda s: jnp.lexsort((jnp.asarray(tiebreak), s)))(ref))
    got = tfused.device_order(torch.tensor(ref), chunk.tiebreak_perm).numpy()
    assert np.array_equal(got, want)


def test_device_order_ties_and_minus_inf():
    rng = np.random.default_rng(5)
    U = S["tflat"].num_units
    scores = rng.integers(-2, 3, size=(6, U)).astype(np.float32)
    scores[rng.random((6, U)) < 0.3] = -np.inf
    tb = S["tflat"].tiebreak
    perm = torch.as_tensor(np.argsort(tb, kind="stable"))
    want = np.asarray(jax.vmap(lambda s: jnp.lexsort((jnp.asarray(tb), s)))(jnp.asarray(scores)))
    got = tfused.device_order(torch.tensor(scores), perm).numpy()
    assert np.array_equal(got, want)
    # float64 host order of the same scores: the same permutation
    sc = {name: scores[1, int(o):int(o + n)].astype(np.float64)
          for name, o, n in zip(S["tflat"].names, S["tflat"].offsets, S["tflat"].sizes)}
    assert np.array_equal(got[1], tmasks.prune_order(sc, S["tflat"]))


# ---------------------------------------------------------------------------
# the server on the device
# ---------------------------------------------------------------------------

def _stacks(rng, W=5, quantized=False):
    if quantized:
        params = {k: rng.choice([-2.0, -1.0, 0.5, 1.0, 2.0], size=(W,) + s).astype(np.float32)
                  for k, s in S["shapes"].items()}
    else:
        params = {k: rng.normal(size=(W,) + s).astype(np.float32) for k, s in S["shapes"].items()}
    pres = _presence(rng, W)
    masks = {k: np.array(v) for k, v in jfleet.masks_from_presence(
        jnp.asarray(pres), S["jflat"], S["jmap"], S["shapes"]).items()}
    return {k: v * masks[k] for k, v in params.items()}, masks


def test_stacked_aggregation_float32_matches_jax():
    rng = np.random.default_rng(6)
    params, masks = _stacks(rng)
    sub = np.asarray([1, 0, 1, 1, 0], np.float32)
    weights = (sub / sub.sum()).astype(np.float32)
    tw = tagg.aggregate_by_worker_stacked_dev({k: torch.tensor(v) for k, v in params.items()},
                                              torch.tensor(weights))
    jw = jagg.aggregate_by_worker_stacked_jnp({k: jnp.asarray(v) for k, v in params.items()},
                                              jnp.asarray(weights))
    tu = tagg.aggregate_by_unit_stacked_dev({k: torch.tensor(v) for k, v in params.items()},
                                            {k: torch.tensor(v) for k, v in masks.items()},
                                            torch.tensor(sub))
    ju = jagg.aggregate_by_unit_stacked_jnp({k: jnp.asarray(v) for k, v in params.items()},
                                            {k: jnp.asarray(v) for k, v in masks.items()},
                                            jnp.asarray(sub))
    for k in params:
        assert tw[k].dtype == tu[k].dtype == torch.float32
        np.testing.assert_allclose(tw[k].numpy(), np.asarray(jw[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_dgc_compress_dev_matches_jax_and_host(masked, quantized):
    rng = np.random.default_rng(8 + quantized)
    deltas, masks = _stacks(rng, quantized=quantized)
    residual = {k: 0.3 * rng.normal(size=v.shape).astype(np.float32) * masks[k]
                for k, v in deltas.items()}
    if masked:
        for v in masks.values():   # row 4 fully masked
            v[4] = 0.0
    rows = np.asarray([1, 1, 0, 1, 1], np.float32)
    sparsity = 0.7
    m = masks if masked else None
    tc, tr, tk, tt = tagg.dgc_compress_dev(
        {k: torch.tensor(v) for k, v in deltas.items()},
        {k: torch.tensor(v) for k, v in residual.items()}, sparsity,
        None if m is None else {k: torch.tensor(v) for k, v in m.items()}, torch.tensor(rows))
    jc, jr, jk, jt = jagg.dgc_compress_jnp(
        {k: jnp.asarray(v) for k, v in deltas.items()},
        {k: jnp.asarray(v) for k, v in residual.items()}, sparsity,
        None if m is None else {k: jnp.asarray(v) for k, v in m.items()}, jnp.asarray(rows))
    assert np.array_equal(tk.numpy(), np.asarray(jk)) and np.array_equal(tt.numpy(),
                                                                         np.asarray(jt))
    hc, hr, hf = tsim._dgc_compress_stacked(deltas, residual, sparsity, masks=m,
                                            rows=rows.astype(bool))
    kept = tk.numpy().astype(np.float64)
    np.testing.assert_array_equal(
        np.where(rows > 0, 1.25 * kept / np.maximum(tt.numpy(), 1), 1.0), hf)
    for k in deltas:
        keep_t = tc[k].numpy() != 0
        assert np.array_equal(keep_t, np.asarray(jc[k]) != 0), k
        assert np.array_equal(keep_t, hc[k] != 0), k
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tr[k].numpy(), hr[k], rtol=0, atol=1e-6)
    assert (tk.numpy()[2] == 0) and (tt.numpy()[2] == 0)   # the gated row commits nothing
    np.testing.assert_array_equal(tr["fc/w"].numpy()[2], residual["fc/w"][2])


@pytest.mark.parametrize("method", ["fedasync_s", "ssp_s", "dcasgd_s"])
def test_async_commit_dev_matches_jax(method):
    rng = np.random.default_rng(12)
    W = 3
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in S["shapes"].items()}
    kw = dict(cohort_size=2, fedasync_a=0.6, lr=0.05, dcasgd_lambda=2.0, dcasgd_m=0.95)
    jg, tg = {k: jnp.asarray(v) for k, v in g.items()}, {k: torch.tensor(v) for k, v in g.items()}
    dc = method == "dcasgd_s"
    jb = {k: jnp.broadcast_to(v, (W,) + v.shape) for k, v in jg.items()} if dc else {}
    tb = {k: v.unsqueeze(0).repeat((W,) + (1,) * v.dim()) for k, v in tg.items()} if dc else {}
    jm = {k: jnp.zeros_like(v) for k, v in jg.items()} if dc else {}
    tm = {k: torch.zeros_like(v) for k, v in tg.items()} if dc else {}
    for step in range(6):
        w = int(rng.integers(W))
        s = int(rng.integers(5))
        fetched = {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32) for k, v in g.items()}
        trained = {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
                   for k, v in fetched.items()}
        jg, jb, jm = jagg.async_commit_jnp(
            method, jg, {k: jnp.asarray(v) for k, v in trained.items()},
            {k: jnp.asarray(v) for k, v in fetched.items()}, jnp.asarray(s, jnp.int32),
            jnp.asarray(w, jnp.int32), jb, jm, **kw)
        new, tm = tagg.async_commit_dev(
            method, tg, {k: torch.tensor(v) for k, v in trained.items()},
            {k: torch.tensor(v) for k, v in fetched.items()}, torch.tensor(s),
            {k: v[w] for k, v in tb.items()}, tm, **kw)
        tg = new
        for k, v in tb.items():
            v[w] = new[k]
        for k in g:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=0, atol=1e-6)
            if dc:
                np.testing.assert_allclose(tb[k].numpy(), np.asarray(jb[k]), rtol=0, atol=1e-6)
                np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-6,
                                           atol=1e-6)


# ---------------------------------------------------------------------------
# the device event queue
# ---------------------------------------------------------------------------

def test_async_pop_perm_goldens():
    hi, lo = tfused.split_time_keys(np.asarray([5.0, 3.0, 5.0, 3.0]))
    perm = tfused.async_pop_perm(torch.tensor(hi), torch.tensor(lo),
                                 torch.tensor([3, 2, 1, 0])).numpy()
    np.testing.assert_array_equal(perm, [3, 1, 2, 0])
    t = np.asarray([1.0, 1.0 + 2**-30, 1.0 + 2**-29], np.float64)
    hi, lo = tfused.split_time_keys(t)
    assert len(set(hi.tolist())) == 1
    perm = tfused.async_pop_perm(torch.tensor(hi), torch.tensor(lo),
                                 torch.tensor([2, 1, 0])).numpy()
    np.testing.assert_array_equal(perm, [0, 1, 2])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_split_keys_and_pop_perm_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 24
    t = rng.choice([1.0, 2.5, 2.5 + 2**-40, 7.0], size=n) + rng.integers(0, 2, n) * 2**-31
    rows = rng.permutation(n) % 9
    hi_t, lo_t = tfused.split_time_keys(t)
    hi_j, lo_j = jfused.split_time_keys(t)
    assert hi_t.tobytes() == hi_j.tobytes() and lo_t.tobytes() == lo_j.tobytes()
    hi_t[-3:] = np.inf     # padding slots
    lo_t[-3:] = 0.0
    got = tfused.async_pop_perm(torch.tensor(hi_t), torch.tensor(lo_t),
                                torch.tensor(rows.astype(np.int64))).numpy()
    want = np.asarray(jfused.async_pop_perm(hi_t, lo_t, rows.astype(np.int32)))
    assert np.array_equal(got, want)
    # the float64 heap order on the real slots: (time, worker)
    real = [i for i in range(n - 3)]
    heap = sorted(real, key=lambda i: (t[i], rows[i], i))
    assert [int(i) for i in got[: n - 3]] == heap
