"""The byzantine noise-mode world, whole runs on the port against the JAX
package.

At ``tests/test_robust.py``'s own config (TINY VGG, 5 workers, 8 rounds,
PI=2, seed 5) under DEFENSE (clip 5, trim 0.2, quarantine with probation
100), workers 0 and 1 add N(0, 1) noise to their deltas, drawn from the
reference's own Threefry stream (``core/prng.py``): each of the port's
``sequential``, ``bucketed``, ``masked`` (``compute="block_skip"``) and
``fused`` engines, from the JAX ``init_cnn`` draw, has the events, clocks
and ledger of the JAX engine of the same name, and params and final_acc
within 1e-3 of JAX sequential or within 2x the envelope where that is
larger (``check_world`` of ``tests/test_torch_robust_channel.py``; the
world is a float32 coin: ``tests/test_torch_robust_chaos.py``).
"""
import pytest
import torch

from test_torch_robust_channel import check_world


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("engine", ["sequential", "bucketed", "masked", "fused"])
def test_noise_world_matches_the_same_jax_engine(engine):
    check_world("noise", engine)
