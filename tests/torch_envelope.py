"""The float32 envelope rule of the port's parity tests (imported by the
``test_torch_*`` files; not a test file itself).

At the reference's test sizes (16 SGD steps a round for 6-8 rounds) a
training run is not a smooth function of its summation order.  A BN output
a few 1e-8 from zero sits on a ReLU gate, and a convolution summed in
another order flips it: one step's weight gradient then moves by ~1e-3,
and the following rounds carry that to 1e-2 in params and a few test
images in accuracy.  XLA's CPU backend picks its summation order by ISA
(AVX-512, AVX2, SSE4.2), so the reference's own engines land on different
sides of such gates on different CPUs (ROADMAP queue C), and so may the
port.

``assert_within_envelope`` holds a port run to a reference run: first at
the reference's own bars; where it misses them, at ``ENVELOPE_EXCESS``
times the envelope measured in the same test on the same machine — the
largest distance between any two of the port's own runs of the world: the
run held, and the run from its init one ulp up, one ulp down and with its
CPU convolutions summed in another order (``perturbations``).  No distance
between two reference runs enters a port run's envelope.  The perturbed
runs are made only when the reference's bars are missed, and only until
the envelope covers the distance.  A witness between two reference
engines passes the reference's own perturbed runs the same way.
Events, clocks, ledgers and counters are held exactly elsewhere; this rule
covers only params and final accuracy.
"""
import contextlib

import numpy as np
import torch

ENVELOPE_EXCESS = 2.0


def params_maxdiff(a, b) -> float:
    """Largest |a - b| over the global params of two results."""
    return max(float(np.max(np.abs(np.asarray(a.global_params[k], np.float32)
                                   - np.asarray(b.global_params[k], np.float32))))
               for k in a.global_params)


def ulp(params, bump):
    """``params`` moved one ulp toward +inf (``"up"``) or -inf (``"down"``),
    or as they are for ``None``."""
    if bump is None:
        return params
    to = np.float32(np.inf if bump == "up" else -np.inf)
    return {k: np.nextafter(np.asarray(v, np.float32), to) for k, v in params.items()}


@contextlib.contextmanager
def other_order():
    """The CPU convolutions summed in another order: oneDNN off, so torch
    takes its own kernels (the mechanism of the ReLU-gate flips)."""
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = was


def in_other_order(fn):
    """``fn`` as a callable that runs it under ``other_order``."""
    def run():
        with other_order():
            return fn()
    return run


def perturbations(run):
    """The perturbed runs of a port run ``run(bump)``: from the init one ulp
    up and down, and from the init itself in the other summation order."""
    return [lambda: run("up"), lambda: run("down"), in_other_order(lambda: run(None))]


def _pairs(held, perturbed):
    """Every pair among ``held`` and the runs of ``perturbed`` (callables),
    each run made when it is first needed."""
    pool = [held]
    for make in perturbed:
        run = make()
        for other in pool:
            yield other, run
        pool.append(run)


def assert_within_envelope(held, oracle, *, bar, acc_bar=1e-3, perturbed=(), what=""):
    """Params of ``held`` within ``bar`` of ``oracle`` and final accuracy
    within ``acc_bar`` (the reference's bars), or each within
    ``ENVELOPE_EXCESS`` times the envelope (``_pairs``) where that is
    larger.  The envelope only grows with each run added, so the runs stop
    as soon as it covers both distances.  Returns the distances, the
    envelope and the bars used."""
    d = params_maxdiff(held, oracle)
    a = abs(held.final_acc - oracle.final_acc)
    env_p = env_a = 0.0
    made = [held]

    def reading():
        return dict(params=d, acc=a, env_params=env_p, env_acc=env_a, runs=len(made) - 1,
                    params_bar=max(bar, ENVELOPE_EXCESS * env_p),
                    acc_bar=max(acc_bar, ENVELOPE_EXCESS * env_a))

    if d <= bar and a <= acc_bar:
        return reading()
    for x, y in _pairs(held, perturbed):
        if y is not made[-1]:
            made.append(y)
        env_p = max(env_p, params_maxdiff(x, y))
        env_a = max(env_a, abs(x.final_acc - y.final_acc))
        r = reading()
        if d <= r["params_bar"] and a <= r["acc_bar"] + 1e-12:
            return r
    raise AssertionError(
        f"{what}: params {d:.3e} (bar {bar:g}, envelope {env_p:.3e}), "
        f"final_acc {a:.5f} (bar {acc_bar:g}, envelope {env_a:.5f}), "
        f"{len(made) - 1} perturbed runs")
