"""The dry-run's argument bytes on the card (``cuda``; skips without one):
the bytes ``launch.dryrun.argument_bytes`` gives a small train step's
arguments at one device against what ``torch.cuda.memory_allocated()``
counts for the same arguments made on the card, to the allocator's
rounding (512 bytes a block).  No JAX here: the count is the port's own.
"""
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.launch import dryrun as TD
from repro_torch.optim import optimizers as t_opt


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step's kernels build with nvcc and run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_argument_bytes_match_the_card(card):
    cfg = t_configs.smoke_config("recurrentgemma-9b").replace(num_layers=3)
    _, abstract_args = TD.make_step(cfg, "train_4k")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    args = abstract_args(device=card, batch=8, seq=64)
    held = torch.cuda.memory_allocated() - before
    leaves = [t for t in t_opt.tree_leaves(args) if isinstance(t, torch.Tensor)]
    predicted = TD.argument_bytes(cfg, "train_4k", args, TD.ONE_DEVICE)
    assert predicted == sum(t.numel() * t.element_size() for t in leaves)
    assert 0 <= held - predicted <= 512 * len(leaves)
