"""``ModelConfig.remat`` in the port (``models/transformer.py``), on the CPU.

The reference rematerialises each scanned period group, each remainder
block when no cache is collected and each encoder layer under
``cfg.remat`` (``repro/models/transformer.py:314-315, 341-349``).  The port
checkpoints the same pieces with ``torch.utils.checkpoint`` while autograd
records them; the recompute runs the same operations on the same inputs,
so the loss and every gradient leaf are held **bit for bit** to
``remat=False``, for every block kind (``attn``, ``local``, ``moe``,
``moe_local``, ``rglru``, ``mlstm``, ``slstm``) and the Whisper encoder,
with period groups and remainder blocks both present, and at the training
batch of ``train_loop`` (8 x 64 tokens), run to run.  The pieces that
were checkpointed are counted; nothing is checkpointed without grad.  An
installed ``RoutingSpy`` replaying expert choices sees each MoE layer once
a step under remat, and routes the recompute as the forward.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.launch.train import loss_and_grads, train_batch
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as TT
from repro_torch.optim.optimizers import tree_leaves

# (arch, config changes, checkpointed pieces a forward): num_layers 3 over
# a period of 2 gives one group and one remainder block
CASES = {
    "attn_local": ("gemma2-2b", dict(num_layers=3), 2),
    "moe_moe_local": ("llama4-maverick-400b-a17b",
                      dict(num_layers=3, block_pattern=("moe", "moe_local"), window_size=8), 2),
    "rglru_local": ("recurrentgemma-9b", dict(num_layers=3), 2),
    "mlstm_slstm": ("xlstm-1.3b", dict(num_layers=3), 2),
    "encoder_decoder": ("whisper-small", dict(num_layers=2), 2 + 2),
    "unscanned_moe": ("granite-moe-1b-a400m", dict(num_layers=2, scan_layers=False), 2),
}


def _batch(cfg, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 12))
    b = train_batch(cfg, toks, "cpu")
    if cfg.encoder_layers:
        g = torch.Generator().manual_seed(seed)
        b["enc_embeds"] = 0.5 * torch.randn(b["enc_embeds"].shape, generator=g)
    return b


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread beats a pool of them,
    which only contends with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def count_checkpoints(monkeypatch):
    calls = []
    real = TT.checkpoint

    def counted(*args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*args, **kw)

    monkeypatch.setattr(TT, "checkpoint", counted)
    return calls


@pytest.mark.parametrize("case", list(CASES))
def test_remat_is_bit_identical_for_every_block_kind(case, count_checkpoints):
    arch, changes, pieces = CASES[case]
    cfg = t_configs.smoke_config(arch).replace(**changes)
    params = TT.init_params(torch.Generator().manual_seed(1), cfg)
    batch = _batch(cfg)
    loss0, grads0 = loss_and_grads(params, cfg.replace(remat=False), batch)
    assert count_checkpoints == []
    loss1, grads1 = loss_and_grads(params, cfg.replace(remat=True), batch)
    assert count_checkpoints == [False] * pieces
    assert torch.equal(loss0, loss1)
    g0, g1 = tree_leaves(grads0), tree_leaves(grads1)
    assert len(g0) == len(g1) == len(tree_leaves(params))
    for i, (a, b) in enumerate(zip(g0, g1)):
        assert a.dtype == b.dtype and torch.equal(a, b), i
    # no recorded graph, nothing checkpointed: a plain forward and a prefill
    count_checkpoints.clear()
    TT.forward(params, cfg, batch)
    TT.prefill(params, cfg, batch)
    assert count_checkpoints == []


def test_remat_is_bit_identical_at_the_training_batch():
    """At ``train_loop``'s 8 x 64 tokens the embedding's backward sums a
    row's gradients over many positions: it must do so in one order on
    every run (``F.embedding``), or no two runs, remat or not, agree.  Two
    intra-op threads are enough for indexing's scatter-add to accumulate in
    thread order."""
    cfg = t_configs.smoke_config("recurrentgemma-9b").replace(num_layers=3)
    params = TT.init_params(torch.Generator().manual_seed(4), cfg)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (8, 64))
    batch = train_batch(cfg, toks, "cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        runs = [loss_and_grads(params, cfg.replace(remat=r), batch)
                for r in (True, False, True, False, True, False)]
    finally:
        torch.set_num_threads(n)
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), tree_leaves(runs[0][1])))


def test_moe_routing_spy_replays_the_recompute():
    """Under remat a replaying spy records each MoE layer once, and the
    recompute routes as the forward did: the gradients are those of the
    same replay without remat."""
    cfg = t_configs.smoke_config("granite-moe-1b-a400m").replace(
        num_layers=3, moe_capacity_factor=1.0)
    params = TT.init_params(torch.Generator().manual_seed(2), cfg)
    batch = _batch(cfg, seed=3)
    with t_moe.RoutingSpy().installed() as first:
        TT.forward(params, cfg, batch)
    # replay the experts the first token did not choose, in every layer
    replay = [c.clone() for c in first.choices()]
    for c in replay:
        others = sorted(set(range(cfg.num_experts)) - set(c[0].tolist()))
        c[0] = torch.tensor(others[:cfg.experts_per_tok])
    out = {}
    for remat in (False, True):
        spy = t_moe.RoutingSpy(replay=replay)
        with spy.installed():
            out[remat] = loss_and_grads(params, cfg.replace(remat=remat), batch)
        assert len(spy.calls) == cfg.num_layers
        assert all(bool(c["flipped"][0]) for c in spy.calls)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(tree_leaves(out[False][1]), tree_leaves(out[True][1])):
        assert torch.equal(a, b)
