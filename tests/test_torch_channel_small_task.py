"""The lossy-channel and byzantine noise-mode worlds of
``tests/test_torch_robust_channel.py`` at a 160-image task (two SGD steps a
round), where neither world is chaotic: every port engine in both worlds
meets the whole contract against the JAX engine of the same name, on
``test_robust.py``'s config (TINY VGG, 5 workers, 8 rounds, PI=2, seed 5)
under its defense (clip 5, trim 0.2, quarantine): events, clocks, comm
bytes and ledger exact, final_acc within 1e-3 and every param within 1e-4
(ROADMAP's parity contract).  Both packages start from the JAX
``init_cnn`` draw.
"""
import numpy as np
import pytest
import torch
from test_torch_robust_channel import ENGINES, SMALL_TASK, assert_events_match, jax_run, port_run


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", ["chan", "noise"])
def test_world_meets_the_whole_contract_at_the_small_task(name, engine):
    """At a 160-image task (two SGD steps a round) neither world is chaotic:
    each port engine against the JAX engine of the same name, events,
    clocks, comm bytes and ledger exact, final_acc within 1e-3 and every
    param within 1e-4 (ROADMAP's parity contract)."""
    ref = jax_run(engine, name, task=SMALL_TASK)
    port = port_run(engine, name, task=SMALL_TASK)
    assert_events_match(ref, port)
    assert abs(ref.final_acc - port.final_acc) <= 1e-3
    for k in ref.global_params:
        np.testing.assert_allclose(port.global_params[k], ref.global_params[k], rtol=0,
                                   atol=1e-4, err_msg=k)
    if name == "chan":
        assert port.retry_total > 0 and port.dup_commits > 0 and port.corrupt_commits > 0
    else:
        assert port.byz_commits > 0 and port.quarantined_commits > 0
