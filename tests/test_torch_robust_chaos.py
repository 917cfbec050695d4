"""The witness that the channel and byzantine noise-mode worlds are a
float32 coin at ``tests/test_robust.py``'s size.

From the JAX ``init_cnn`` draw itself, JAX ``sequential`` and JAX
``bucketed`` may part by 1e-2 in params and miss the reference's own
contract in final_acc, with identical prune events, clocks and ledgers;
whether they do depends on the CPU.  Float32 chaos, not a difference in
what the engines compute: 16 SGD steps a round for 8 rounds amplify the
order of a sum (a batched call's convolution, a clip scale's last bit),
which XLA's CPU backend picks by ISA.  What holds on every CPU: the two
JAX engines lie within 1e-3, or within 2x the distance between runs of
the world from the init moved one ulp or summed in another order; each of
the port's two engines meets the whole contract against one of the two
JAX engines, or lies within 2x its own envelope of JAX sequential, and its
events, clocks and ledger equal both.  So
``tests/test_torch_robust_channel.py`` and ``test_torch_robust_noise.py``
hold every engine's params within 2x its own envelope at this size, and
the whole contract at a 160-image task.
"""
import numpy as np
import pytest
import torch
from torch_envelope import assert_within_envelope, in_other_order, perturbations, ulp

from test_torch_robust_channel import INIT, jax_run, maxdiff, port_run

LEDGER_FIELDS = ("drift_events", "rounds_degraded", "rounds_skipped", "workers_recovered",
                 "retry_total", "byz_commits", "lost_commits", "dup_commits", "corrupt_commits",
                 "quarantined_commits")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def events_equal(ref, other) -> bool:
    return (ref.prune_events == other.prune_events
            and ref.scenario_rounds == other.scenario_rounds
            and np.array_equal(np.array(ref.update_times), np.array(other.update_times),
                               equal_nan=True)
            and abs(ref.total_time - other.total_time) <= 1e-9
            and abs(ref.comm_bytes - other.comm_bytes) <= 1e-6
            and all(getattr(ref, f) == getattr(other, f) for f in LEDGER_FIELDS))


def contract_holds(ref, other) -> bool:
    """``tests/test_robust.py``'s ``_assert_engines_match`` as a bool."""
    return abs(ref.final_acc - other.final_acc) <= 1e-3 and events_equal(ref, other)


@pytest.mark.parametrize("name", ["chan", "noise"])
def test_jax_sequential_and_bucketed_part_by_chaos(name):
    jseq, jbuck = jax_run("sequential", name), jax_run("bucketed", name)
    assert events_equal(jseq, jbuck)
    port_seq = {b: (lambda b=b: port_run("sequential", name, init=ulp(INIT, b)))
                for b in (None, "up", "down")}
    port_seq["order"] = in_other_order(port_seq[None])
    assert_within_envelope(jseq, jbuck, bar=1e-3, what=f"{name}: JAX engines", perturbed=[
        lambda b=b: jax_run("sequential", name, init=ulp(INIT, b)) for b in ("up", "down")]
        + list(port_seq.values()))
    for engine in ("sequential", "bucketed"):
        port = port_run(engine, name, init=INIT)
        assert events_equal(jseq, port) and events_equal(jbuck, port)
        sides = [contract_holds(ref, port) and maxdiff(ref, port) <= 1e-3
                 for ref in (jseq, jbuck)]
        if not any(sides):
            assert_within_envelope(
                port, jseq, bar=1e-3, what=f"{name}/{engine}",
                perturbed=perturbations(lambda b: port_run(engine, name, init=ulp(INIT, b))))
