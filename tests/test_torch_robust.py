"""The robust aggregation layer's pieces on the port against the JAX package.

* ``core.prng``: ``prng_key`` and ``fold_in`` equal to ``jax.random``'s
  keys; ``bits`` bit for bit equal to ``jax.random.bits`` for the keys the
  simulator draws with (``fold_in(fold_in(PRNGKey(s + 51721), t), i)``) at
  1-D, ``[W, C]`` and ``[W, C, 3, 3]`` shapes, and from any counter offset;
  ``uniform`` bit for bit equal to ``jax.random.uniform`` on
  ``(nextafter(-1, 0), 1)``; ``normal`` within ``NORMAL_ATOL`` (4.8e-7 over
  200 000 draws, one float32 ulp at |x| ~ 4; 99 % bit-equal), where
  ``torch.erfinv`` in its place stays 2.1e-5 away;
* on ``tests/test_robust.py``'s ``_stacks(w=6)``: the three byzantine modes
  and the channel's corruption (noise rows at their full-fleet counters),
  the pre-clip norms and the clip, the trimmed mean, the plain-mean route
  of ``trim == 0``, the quarantine's health steps (sync and async) and the
  whole ``robust_submission_step_dev`` against their ``*_jnp`` twins;
* the reference's own goldens mirrored: ``clip=inf`` and ``trim=0`` are
  bit-exact no-ops, the quarantine enters and exits on its schedule, a
  frozen ``gate`` moves no carry, a duplicated delivery is one vote, a lost
  commit cannot vote;
* ``AsyncServer``'s clip and quarantine against the reference's, and
  ``async_commit_dev``'s clip against ``async_commit_jnp``.

Sums differ in order between XLA and torch (norms, the plain mean's
tensordot), so those twins hold a float32 tolerance stated where it is
used; order statistics, masks, rows and the health carries are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro_torch.core import aggregation as tagg
from repro_torch.core import prng

W = 6
NORMAL_ATOL = 1e-6       # port normal vs jax.random.normal
SUM_RTOL = 2e-6          # sums taken in another order (norms, tensordot)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stacks(w=W, seed=0):
    """``tests/test_robust.py``'s ``_stacks``: raw stacks, masked stacks and
    masks, as numpy float32."""
    rng = np.random.default_rng(seed)
    stacks = {
        "conv/w": rng.normal(0, 1, (w, 3, 4)).astype(np.float32),
        "fc/w": rng.normal(0, 1, (w, 5)).astype(np.float32),
    }
    masks = {k: (rng.random(v.shape) > 0.3).astype(np.float32) for k, v in stacks.items()}
    return stacks, {k: stacks[k] * masks[k] for k in stacks}, masks


def J(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def T(d):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in d.items()}


def N(d):
    return {k: np.asarray(v) for k, v in d.items()}


def assert_same(a, b, rtol=0.0, atol=0.0):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k].numpy() if isinstance(b[k], torch.Tensor)
                                            else b[k])
        if rtol == 0.0 and atol == 0.0:
            assert np.array_equal(x, y), k
        else:
            np.testing.assert_allclose(y, x, rtol=rtol, atol=atol, err_msg=k)


def jkey(k):
    return tuple(int(x) for x in np.asarray(k))


# ---------------------------------------------------------------------------
# core.prng against jax.random
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 5 + 51721, 5 + 51722, 2**31 - 1])
def test_prng_key_and_fold_in_are_jax_keys(seed):
    assert prng.prng_key(seed) == jkey(jax.random.PRNGKey(seed))
    for t in (0, 1, 7, 2**20 + 3):
        assert prng.fold_in(prng.prng_key(seed), t) == jkey(
            jax.random.fold_in(jax.random.PRNGKey(seed), t))
    assert tagg.noise_key(seed, 3) == jkey(jagg.noise_key(seed, 3))


@pytest.mark.parametrize("shape", [(37,), (W, 64), (W, 16, 3, 3), (2, 3, 3, 5, 7)])
@pytest.mark.parametrize("t,i", [(1, 0), (4, 3), (8, 1001)])
def test_bits_equal_jax_random_bits(shape, t, i):
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5 + 51721), t), i)
    pk = prng.fold_in(prng.fold_in(prng.prng_key(5 + 51721), t), i)
    assert pk == jkey(jk)
    n = int(np.prod(shape))
    want = np.asarray(jax.random.bits(jk, shape)).astype(np.int64).ravel()
    assert np.array_equal(prng.bits(pk, n).numpy(), want)
    # any counter window of the same draw: row 2 alone, a ragged tail
    assert np.array_equal(prng.bits(pk, n - n // 3, offset=n // 3).numpy(), want[n // 3:])
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.asarray(jax.random.uniform(jk, shape, jnp.float32, lo, 1.0)).ravel()
    assert np.array_equal(prng.uniform(pk, n).numpy(), u)


def test_normal_within_stated_tolerance_of_jax():
    jk = jax.random.fold_in(jax.random.PRNGKey(5 + 51722), 3)
    pk = prng.fold_in(prng.prng_key(5 + 51722), 3)
    n = 200_000
    want = np.asarray(jax.random.normal(jk, (n,)))
    got = prng.normal(pk, (n,)).numpy()
    err = np.abs(got - want)
    assert err.max() <= NORMAL_ATOL
    assert (err == 0).mean() >= 0.98
    # XLA's erf_inv, not torch's: torch.erfinv lands 2e-5 away
    u = prng.uniform(pk, n)
    alt = (torch.erfinv(u) * float(np.float32(np.sqrt(2)))).numpy()
    assert np.abs(alt - want).max() > 10 * NORMAL_ATOL
    # chunked draws equal one draw; a row window equals that row
    old = prng.CHUNK
    try:
        prng.CHUNK = 4096
        assert np.array_equal(prng.normal(pk, (n,)).numpy(), got)
    finally:
        prng.CHUNK = old
    full = prng.normal(pk, (4, 500))
    assert torch.equal(prng.normal(pk, (500,), offset=1000), full[2])


@pytest.mark.parametrize("full_rows,row_offset", [(None, None), (2 * W, W), (3 * W, 0)])
def test_stack_noise_rows_at_full_fleet_counters(full_rows, row_offset):
    _, stacks, _ = _stacks()
    leaf = stacks["conv/w"]
    jk = jagg.noise_key(5 + 51721, 2)
    want = np.asarray(jagg._stack_noise(jk, 1, jnp.asarray(leaf), full_rows, row_offset))
    tk = tagg.noise_key(5 + 51721, 2)
    got = tagg._stack_noise(tk, 1, torch.as_tensor(leaf), full_rows, row_offset).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)
    rows = tagg._stack_noise(tk, 1, torch.as_tensor(leaf), full_rows, row_offset, [4, 1]).numpy()
    assert np.array_equal(rows, got[[4, 1]])


# ---------------------------------------------------------------------------
# the submission-boundary transforms
# ---------------------------------------------------------------------------

BYZ_ROW = np.array([True, False, False, True, False, False])


@pytest.mark.parametrize("mode", ["sign_flip", "scale", "noise"])
@pytest.mark.parametrize("masked", [True, False])
def test_byzantine_transform_matches_jax(mode, masked):
    _, stacks, masks = _stacks()
    deltas = {k: v - 0.25 for k, v in stacks.items()}
    m = masks if masked else None
    kw = dict(mode=mode, scale=-7.5, noise_std=2.0)
    want = jagg.byzantine_transform_jnp(J(deltas), J(m) if masked else None,
                                        jnp.asarray(BYZ_ROW), key=jagg.noise_key(11, 4), **kw)
    got = tagg.byzantine_transform_dev(T(deltas), T(m) if masked else None, BYZ_ROW,
                                       key=tagg.noise_key(11, 4), **kw)
    assert_same(want, got, atol=0.0 if mode != "noise" else 2.0 * NORMAL_ATOL)
    for k in deltas:    # honest rows pass through bit-untouched
        assert np.array_equal(got[k].numpy()[~BYZ_ROW], deltas[k][~BYZ_ROW])


def test_corrupt_transform_matches_jax_away_from_the_attack_stream():
    _, stacks, masks = _stacks()
    deltas = {k: v - 0.25 for k, v in stacks.items()}
    row = np.array([False, True, False, False, False, True])
    want = jagg.corrupt_transform_jnp(J(deltas), J(masks), jnp.asarray(row), corrupt_std=10.0,
                                      key=jagg.noise_key(11, 4))
    got = tagg.corrupt_transform_dev(T(deltas), T(masks), row, corrupt_std=10.0,
                                     key=tagg.noise_key(11, 4))
    assert_same(want, got, atol=10.0 * NORMAL_ATOL)
    noise = tagg.byzantine_transform_dev(T(deltas), T(masks), row, mode="noise", scale=1.0,
                                         noise_std=10.0, key=tagg.noise_key(11, 4))
    assert not torch.equal(noise["fc/w"], got["fc/w"])     # leaf 1000 + i
    none = tagg.corrupt_transform_dev(T(deltas), T(masks), np.zeros(W, bool),
                                      corrupt_std=10.0, key=tagg.noise_key(11, 4))
    assert_same(deltas, none)


def test_delta_norms_and_clip_match_jax():
    _, stacks, _ = _stacks()
    deltas = {k: v - 0.5 for k, v in stacks.items()}
    jn = jagg.delta_norms_jnp(J(deltas))
    tn = tagg.delta_norms_dev(T(deltas))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=SUM_RTOL)
    clip = float(np.median(np.asarray(jn)))    # half the rows clip
    want = jagg.clip_deltas_jnp(J(deltas), jn, clip)
    got = tagg.clip_deltas_dev(T(deltas), tn, clip)
    assert_same(want, got, rtol=2 * SUM_RTOL)
    # the same norms give the same clip, bit for bit
    assert_same(want, tagg.clip_deltas_dev(T(deltas), torch.as_tensor(np.array(jn)), clip))


def test_clip_inf_is_a_bit_exact_noop():
    _, stacks, _ = _stacks()
    deltas = {k: torch.as_tensor(v - 0.5) for k, v in stacks.items()}
    norms = tagg.delta_norms_dev(deltas)
    for clip in (float("inf"), float(norms.max()) * 2.0):
        out = tagg.clip_deltas_dev(deltas, norms, clip)
        for k in deltas:
            assert torch.equal(out[k], deltas[k])


# ---------------------------------------------------------------------------
# aggregation: plain route, trimmed mean
# ---------------------------------------------------------------------------

def test_trim0_is_plain_aggregation_bit_exact():
    _, stacks, masks = _stacks()
    w = torch.as_tensor(np.float32([0.1, 0.3, 0.0, 0.2, 0.25, 0.15]))
    plain = tagg.aggregate_by_worker_stacked_dev(T(stacks), w)
    robust = tagg.robust_aggregate_stacked_dev(T(stacks), w, T(masks), trim=0.0)
    assert_same(N({k: v.numpy() for k, v in plain.items()}), robust)
    jplain = jagg.aggregate_by_worker_stacked_jnp(J(stacks), jnp.asarray(w.numpy()))
    assert_same(jplain, plain, rtol=SUM_RTOL, atol=1e-7)


@pytest.mark.parametrize("trim", [0.2, 0.34, 0.49])
@pytest.mark.parametrize("masked", [True, False])
def test_trimmed_mean_matches_jax(trim, masked):
    _, stacks, masks = _stacks(seed=3)
    elig = np.array([True, True, False, True, True, True])
    want = jagg.trimmed_mean_stacked_jnp(J(stacks), J(masks) if masked else None,
                                         jnp.asarray(elig), trim)
    got = tagg.trimmed_mean_stacked_dev(T(stacks), T(masks) if masked else None,
                                        torch.as_tensor(elig), trim)
    assert_same(want, got, rtol=1e-6, atol=1e-7)


def test_trimmed_mean_ignores_duplicate_multiplicity():
    _, stacks, masks = _stacks()
    g = {k: torch.zeros(v.shape[1:]) for k, v in stacks.items()}
    once = torch.ones(W)
    duped = torch.as_tensor(np.float32([2, 1, 1, 3, 1, 1]))
    outs = [tagg.robust_submission_step_dev(T(stacks), T(masks), g, m, m / m.sum(), None, None,
                                            None, None, None, None, clip=None, trim=0.2)[0]
            for m in (once, duped)]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k])


def test_lost_commit_payload_cannot_vote():
    _, stacks, masks = _stacks()
    g = {k: torch.zeros(v.shape[1:]) for k, v in stacks.items()}
    mult = torch.as_tensor(np.float32([0, 1, 1, 1, 1, 1]))
    garbled = T(stacks)
    for v in garbled.values():
        v[0] = 1e9
    outs = [tagg.robust_submission_step_dev(s, T(masks), g, mult, mult / mult.sum(), None, None,
                                            None, None, None, None, clip=None, trim=0.2)[0]
            for s in (T(stacks), garbled)]
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k])


# ---------------------------------------------------------------------------
# the quarantine's health steps
# ---------------------------------------------------------------------------

def test_quarantine_enter_exit_schedule():
    """Worker 0's norm is a 10x MAD outlier every round it is eligible:
    2 strikes -> 3 probation rounds out -> readmitted -> struck again."""
    strikes = torch.zeros(5, dtype=torch.int32)
    quar = torch.zeros(5, dtype=torch.int32)
    norms = torch.as_tensor(np.float32([10.0, 1.0, 1.0, 1.0, 1.0]))
    elig = torch.ones(5, dtype=torch.bool)
    seen = []
    for _ in range(8):
        quar_now, strikes, quar = tagg.health_step_dev(
            norms, elig, strikes, quar, threshold=3.0, strikes_needed=2, probation=3)
        seen.append(bool(quar_now[0]))
        assert not quar_now[1:].any()
    assert seen == [False, False, True, True, True, False, False, True]


def test_quarantine_gate_freezes_state():
    strikes = torch.as_tensor(np.int32([1, 0, 0]))
    quar = torch.as_tensor(np.int32([0, 2, 0]))
    norms = torch.as_tensor(np.float32([50.0, 1.0, 1.0]))
    _, st2, qu2 = tagg.health_step_dev(norms, torch.ones(3, dtype=torch.bool), strikes, quar,
                                       threshold=3.0, strikes_needed=2, probation=3, gate=False)
    assert torch.equal(st2, strikes) and torch.equal(qu2, quar)


def test_health_step_matches_jax_over_random_rounds():
    rng = np.random.default_rng(4)
    n = 9
    js, jq = jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32)
    ts, tq = torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)
    entered = 0
    for r in range(40):
        norms = rng.lognormal(0, 0.3, n).astype(np.float32)
        norms[rng.random(n) < 0.25] *= 20.0
        elig = rng.random(n) < 0.8
        if r == 7:
            elig[:] = False      # nobody eligible: medians of an all-inf row
        kw = dict(threshold=2.5, strikes_needed=2, probation=2)
        jnow, js, jq = jagg.health_step_jnp(jnp.asarray(norms), jnp.asarray(elig), js, jq, **kw)
        tnow, ts, tq = tagg.health_step_dev(torch.as_tensor(norms), torch.as_tensor(elig),
                                            ts, tq, **kw)
        assert np.array_equal(np.asarray(jnow), tnow.numpy())
        assert np.array_equal(np.asarray(js), ts.numpy())
        assert np.array_equal(np.asarray(jq), tq.numpy())
        entered += int(tnow.sum())
    assert entered > 0


def test_async_health_step_matches_jax_and_the_host_server():
    rng = np.random.default_rng(6)
    n = 5
    kw = dict(threshold=1.0, strikes_needed=1, probation=2)
    jc = (jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.float32),
          jnp.zeros(n, bool))
    tc = (torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
          torch.zeros(n), torch.zeros(n, dtype=torch.bool))
    host = tagg.AsyncServer("fedasync_s", {"x": np.zeros(1, np.float32)}, n,
                            quarantine=tagg.QuarantineConfig(threshold=1.0, strikes=1,
                                                             probation=2))
    rejects = 0
    for _ in range(30):
        w = int(rng.integers(n))
        norm = np.float32(rng.lognormal(0, 0.5) * (8.0 if w == 2 else 1.0))
        jr, *jc = jagg.async_health_step_jnp(jnp.asarray(norm), jnp.asarray(w, jnp.int32),
                                             *jc, **kw)
        tr, *tc = tagg.async_health_step_dev(torch.as_tensor(norm), torch.as_tensor(w),
                                             *tc, **kw)
        hr = host._health_step(norm, w)
        assert bool(jr) == bool(tr) == hr
        for a, b in zip(jc, tc):
            assert np.array_equal(np.asarray(a), b.numpy())
        assert np.array_equal(host.strikes, tc[0].numpy())
        assert np.array_equal(host.quar_left, tc[1].numpy())
        rejects += hr
    assert rejects > 0


# ---------------------------------------------------------------------------
# the whole server round
# ---------------------------------------------------------------------------

CASES = {
    "clip": dict(clip=2.0),
    "trim": dict(trim=0.2),
    "quarantine": dict(quarantine=(3.0, 1, 2)),
    "quarantine_trim": dict(trim=0.34, quarantine=(2.0, 1, 3)),
    "byz_scale": dict(byz="scale", clip=4.0),
    "byz_noise_corrupt": dict(byz="noise", corrupt=True, clip=3.0, trim=0.2,
                              quarantine=(3.0, 2, 3)),
    "all_lost": dict(lost=True, clip=1.0, quarantine=(3.0, 1, 2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("masked", [True, False])
def test_robust_submission_step_matches_jax(case, masked):
    spec = CASES[case]
    raw, stacks, masks = _stacks(seed=7)
    rng = np.random.default_rng(8)
    g = {k: rng.normal(0, 0.5, v.shape[1:]).astype(np.float32) for k, v in stacks.items()}
    if not masked:
        stacks = raw
    mult = np.float32([1, 2, 1, 0, 1, 1]) if not spec.get("lost") else np.zeros(W, np.float32)
    weights = (mult / max(mult.sum(), 1)).astype(np.float32)
    byz = np.array([False, True, False, False, False, True]) if "byz" in spec else None
    cor = np.array([True, False, False, False, True, False]) if spec.get("corrupt") else None
    quar = spec.get("quarantine")
    common = dict(byz_mode=spec.get("byz", "sign_flip"), byz_scale=-10.0, byz_noise_std=1.0,
                  corrupt_std=10.0, clip=spec.get("clip"), trim=spec.get("trim", 0.0))
    m = masks if masked else None
    jst = jqu = tst = tqu = None
    if quar is not None:
        jst = jnp.asarray(np.int32([1, 0, 0, 0, 0, 0]))
        jqu = jnp.asarray(np.int32([0, 0, 1, 0, 0, 0]))
        tst, tqu = torch.as_tensor(np.array(jst)), torch.as_tensor(np.array(jqu))
    jq = tq = None
    if quar is not None:
        jq = jagg.QuarantineConfig(threshold=quar[0], strikes=quar[1], probation=quar[2])
        tq = tagg.QuarantineConfig(threshold=quar[0], strikes=quar[1], probation=quar[2])
    jout = jagg.robust_submission_step_jnp(
        J(stacks), J(m) if masked else None, J(g), jnp.asarray(mult), jnp.asarray(weights),
        None if byz is None else jnp.asarray(byz), None if cor is None else jnp.asarray(cor),
        jagg.noise_key(5 + 51721, 3), jagg.noise_key(5 + 51722, 3), jst, jqu,
        quarantine=jq, **common)
    tout = tagg.robust_submission_step_dev(
        T(stacks), T(m) if masked else None, T(g), torch.as_tensor(mult),
        torch.as_tensor(weights), byz, cor, tagg.noise_key(5 + 51721, 3),
        tagg.noise_key(5 + 51722, 3), tst, tqu, quarantine=tq, **common)
    assert_same(jout[0], tout[0], rtol=1e-5, atol=2e-6)
    if quar is None:
        assert tout[1] is None and tout[2] is None and tout[3] is None
    else:
        for a, b in zip(jout[1:], tout[1:]):
            assert np.array_equal(np.asarray(a), b.numpy())
    if spec.get("lost"):     # nothing delivered: the global stays
        assert_same(g, tout[0])


def test_defenseless_robust_step_is_plain_aggregation():
    _, stacks, masks = _stacks()
    w = torch.full((W,), 1.0 / 6.0)
    g = {k: torch.zeros(v.shape[1:]) for k, v in stacks.items()}
    plain = tagg.aggregate_by_worker_stacked_dev(T(stacks), w)
    out, st, qu, quar_now = tagg.robust_submission_step_dev(
        T(stacks), T(masks), g, torch.ones(W), w, None, None, None, None, None, None,
        clip=None, trim=0.0, quarantine=None)
    assert st is None and qu is None and quar_now is None
    for k in plain:
        assert torch.equal(plain[k], out[k])


# ---------------------------------------------------------------------------
# the async half: AsyncServer and async_commit_dev
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["fedasync_s", "ssp_s", "dcasgd_s"])
def test_async_server_clip_and_quarantine_match_the_reference(method):
    rng = np.random.default_rng(9)
    n = 4
    shapes = {"a/w": (3, 4), "b/b": (5,)}
    g0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(cohort_size=3, fedasync_a=0.6, lr=0.05, clip_norm=0.8)
    js = jagg.AsyncServer(method, dict(g0), n, quarantine=jagg.QuarantineConfig(
        threshold=1.0, strikes=1, probation=2), **kw)
    ts = tagg.AsyncServer(method, dict(g0), n, quarantine=tagg.QuarantineConfig(
        threshold=1.0, strikes=1, probation=2), **kw)
    fetched_j = [dict(g0) for _ in range(n)]
    fetched_t = [dict(g0) for _ in range(n)]
    for _ in range(16):
        w, s = int(rng.integers(n)), int(rng.integers(3))
        step = 3.0 if w == 1 else 0.5      # slot 1 commits outliers
        trained = {k: (np.asarray(v, np.float32) + step * rng.normal(size=v.shape))
                   .astype(np.float32) for k, v in fetched_j[w].items()}
        a = js.commit(w, trained, fetched_j[w], s)
        b = ts.commit(w, trained, fetched_t[w], s)
        assert_same(a, b)
        fetched_j[w], fetched_t[w] = dict(a), dict(b)
        assert ts.version == js.version
    assert ts.rejected_commits == js.rejected_commits > 0
    assert np.array_equal(ts.strikes, js.strikes)
    assert np.array_equal(ts.quar_left, js.quar_left)


@pytest.mark.parametrize("method", ["fedasync_s", "ssp_s", "dcasgd_s"])
def test_async_commit_dev_clip_matches_jax(method):
    rng = np.random.default_rng(12)
    n = 3
    shapes = {"a/w": (3, 4), "b/b": (5,)}
    g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(cohort_size=2, fedasync_a=0.6, lr=0.05, dcasgd_lambda=2.0, dcasgd_m=0.95,
              clip_norm=0.7)
    jg, tg = J(g), T(g)
    dc = method == "dcasgd_s"
    jb = {k: jnp.broadcast_to(v, (n,) + v.shape) for k, v in jg.items()} if dc else {}
    tb = {k: v.unsqueeze(0).repeat((n,) + (1,) * v.dim()) for k, v in tg.items()} if dc else {}
    jm = {k: jnp.zeros_like(v) for k, v in jg.items()} if dc else {}
    tm = {k: torch.zeros_like(v) for k, v in tg.items()} if dc else {}
    for _ in range(6):
        w, s = int(rng.integers(n)), int(rng.integers(5))
        fetched = {k: (v + 0.1 * rng.normal(size=v.shape)).astype(np.float32) for k, v in g.items()}
        trained = {k: (v + rng.normal(size=v.shape)).astype(np.float32)
                   for k, v in fetched.items()}
        jg, jb, jm = jagg.async_commit_jnp(method, jg, J(trained), J(fetched),
                                           jnp.asarray(s, jnp.int32), jnp.asarray(w, jnp.int32),
                                           jb, jm, **kw)
        new, tm = tagg.async_commit_dev(method, tg, T(trained), T(fetched), torch.tensor(s),
                                        {k: v[w] for k, v in tb.items()}, tm, **kw)
        tg = new
        for k, v in tb.items():
            v[w] = new[k]
        assert_same(jg, tg, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# config validation: the reference's messages
# ---------------------------------------------------------------------------

def test_robust_config_validation_names_fields():
    with pytest.raises(ValueError, match="robust clip"):
        tagg.RobustAggConfig(clip=0.0)
    with pytest.raises(ValueError, match="robust trim"):
        tagg.RobustAggConfig(trim=0.5)
    with pytest.raises(ValueError, match="quarantine threshold"):
        tagg.QuarantineConfig(threshold=0.0)
    with pytest.raises(ValueError, match="quarantine strikes"):
        tagg.QuarantineConfig(strikes=0)
    with pytest.raises(ValueError, match="quarantine probation"):
        tagg.QuarantineConfig(probation=0)
    assert not tagg.RobustAggConfig().any_active
    assert tagg.RobustAggConfig(clip=1.0).any_active
    assert tagg.RobustAggConfig(trim=0.1).any_active
    assert tagg.RobustAggConfig(quarantine=tagg.QuarantineConfig()).any_active
