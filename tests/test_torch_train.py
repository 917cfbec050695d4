"""The port's LLM training path against the JAX package, on the CPU.

Each comparison starts from one init in both packages, the port's, passed
leaf by leaf through numpy (``convert``), and from the same numpy tokens;
the JAX gradients run jitted.  On the CPU the flash-attention
and RG-LRU wrappers run their plain forwards, and under autograd their plain
backwards (``kernels/ref.py``), so these tests also hold the port's
``_FlashAttention`` / ``_RGLRUScan`` wiring (saved tensors, the GQA sum,
the cross mode, the scan's initial state) against ``jax.grad``.

Bars: ``lm_loss`` within 1e-5 relative; every gradient leaf within
``GRAD_TOL`` = 1e-5 of that leaf's max|g| (measured up to 3e-6: float32
summation order through the layers).  The optimizers on identical numpy
gradients: SGD and momentum bit for bit, AdamW within 4 ulps (XLA's CPU
square root is not IEEE's), the port's functional ``update`` and in-place
``step_`` bit for bit with each other.  The token task and
``batch_iterator`` exactly.  ``train_loop``: the losses within 1e-5
relative; the params within ``2 * steps * lr`` everywhere, the most AdamW
can move two runs apart (its first step is about ``lr * sign(g)``, so a
gradient that is float noise around 0 may take the other sign in the other
package), and at most ``FLIP_SHARE`` = 1e-4 of all elements further than
1e-6 apart (measured: 2.2e-5 at most, on 2.7e-5 of the elements).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.data import synthetic as j_syn
from repro.launch import train as j_train
from repro.models import transformer as JT
from repro.optim import optimizers as j_opt
from repro_torch import configs as t_configs
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.data import synthetic as t_syn
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import rg_lru_scan as rg_mod
from repro_torch.launch import train as t_train
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizers as t_opt


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread beats a pool of them,
    which only contends with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GRAD_TOL = 1e-5
LOSS_TOL = 1e-5
FLIP_SHARE = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pairs(port, ref, path="root"):
    """(path, port leaf, JAX leaf) over the JAX tree's leaves."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), path
        for k in ref:
            yield from _pairs(port[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            yield from _pairs(p, r, f"{path}[{i}]")
    else:
        yield path, np.asarray(port), np.asarray(ref)


# (arch, sequence length, extra batch): windows of the smoke configs are 32
# keys, so 48 tokens cross them; whisper's encoder frames are random here so
# that its encoder's gradients are not those of a constant input
CASES = [
    ("recurrentgemma-9b", 48, None),
    ("gemma2-2b", 48, "loss_mask"),
    ("whisper-small", 40, "enc_embeds"),
    ("xlstm-1.3b", 48, None),
]


@pytest.mark.parametrize("arch,s,extra", CASES)
def test_lm_loss_and_every_gradient_match_jax(arch, s, extra):
    tc, jc = t_configs.smoke_config(arch), j_smoke_config(arch)
    rng = np.random.default_rng(7)
    # any init will do here: the port's, handed to JAX through numpy (the
    # JAX init costs more to compile than the gradient)
    tp = TT.init_params(torch.Generator().manual_seed(3), tc)
    jp = jax.tree.map(jnp.asarray, tree_to_numpy(tp))
    batch = {"tokens": rng.integers(0, tc.vocab_size, size=(2, s)).astype(np.int32)}
    if extra == "loss_mask":
        batch["loss_mask"] = (rng.random((2, s)) < 0.7).astype(np.float32)
    if extra == "enc_embeds":
        batch["enc_embeds"] = (0.5 * rng.standard_normal((2, 16, tc.d_model))).astype(np.float32)
    j_loss, j_grads = jax.jit(jax.value_and_grad(lambda p, b: JT.lm_loss(p, jc, b)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    t_loss, t_grads = t_train.loss_and_grads(
        tp, tc, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=LOSS_TOL)
    n = 0
    for path, g, ref in _pairs(tree_to_numpy(t_grads), _np(j_grads)):
        assert g.shape == ref.shape, path
        top = float(np.abs(ref).max())
        assert top > 0, f"{path}: no gradient reached this leaf"
        assert float(np.abs(g - ref).max()) <= GRAD_TOL * top, path
        n += 1
    assert n == len(jax.tree.leaves(j_grads))


def test_lm_loss_is_cross_entropy_plus_aux():
    """The one-hot contraction picks each label's log-probability, and the
    MoE aux loss is added (granite's smoke config)."""
    tc = t_configs.smoke_config("granite-moe-1b-a400m")
    params = TT.init_params(torch.Generator().manual_seed(0), tc)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, tc.vocab_size, (2, 6)))
    logits, aux = TT.forward(params, tc, {"tokens": toks})
    ce = torch.nn.functional.cross_entropy(logits[:, :-1].reshape(-1, tc.vocab_size),
                                           toks[:, 1:].reshape(-1))
    loss = TT.lm_loss(params, tc, {"tokens": toks})
    assert float(aux) > 0
    torch.testing.assert_close(loss, ce + aux, atol=1e-6, rtol=1e-6)


def _tree(shapes, draw):
    return {k: _tree(v, draw) if isinstance(v, dict) else draw(v) for k, v in shapes.items()}


@pytest.mark.parametrize("name", ["sgd", "momentum_wd", "adamw", "adamw_wd", "adamw_bf16"])
def test_optimizers_match_jax(name):
    make = {
        "sgd": lambda m: m.sgd(0.1),
        "momentum_wd": lambda m: m.momentum(0.05, 0.9, weight_decay=1e-2),
        "adamw": lambda m: m.adamw(3e-4),
        "adamw_wd": lambda m: m.adamw(1e-3, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.1),
        "adamw_bf16": lambda m: m.adamw(3e-4, state_dtype=(
            jnp.bfloat16 if m is j_opt else torch.bfloat16)),
    }[name]
    rng = np.random.default_rng(1)
    shapes = {"w": (5, 7), "blk": {"b": (3,), "s": (4, 2)}}
    p0 = _tree(shapes, lambda s: rng.standard_normal(s).astype(np.float32))
    # gradients over ten decades, some near float noise
    grads = [_tree(shapes, lambda s: (rng.standard_normal(s) * 10.0 ** rng.integers(-8, 2, s))
                   .astype(np.float32)) for _ in range(4)]
    jo, to = make(j_opt), make(t_opt)
    # AdamW divides by a square root, which XLA's CPU backend does not round
    # correctly (one ulp off IEEE on 0.66 % of float32 inputs; torch's is
    # IEEE), and the division and the product with lr that follow turn that
    # ulp into up to 3 ulps of an update: AdamW is held within 4 ulps, the
    # rest exactly
    ulps = 4 if name.startswith("adamw") else 0
    pj = jax.tree.map(jnp.asarray, p0)
    sj = jo.init(pj)
    pt, pi = tree_from_numpy(p0), tree_from_numpy(p0)
    st, si = to.init(pt), to.init(pi)
    for g in grads:
        uj, sj = jo.update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = j_opt.apply_updates(pj, uj)
        ut, st = to.update(tree_from_numpy(g), st, pt)
        pt = t_opt.apply_updates(pt, ut)
        si = to.step_(pi, tree_from_numpy(g), si)
        for path, a, b in _pairs(tree_to_numpy(ut), _np(uj)):
            np.testing.assert_array_max_ulp(a, b, maxulp=ulps)
    for port in (pt, pi):
        for path, a, b in _pairs(tree_to_numpy(port), _np(pj)):
            np.testing.assert_array_max_ulp(a, b, maxulp=ulps)
    for a, b in zip(t_opt.tree_leaves(pt), t_opt.tree_leaves(pi)):
        assert torch.equal(a, b)
    if name.startswith("adamw"):
        for key in ("m", "v"):
            for state in (st, si):
                for path, a, b in _pairs(tree_to_numpy(state[key]), _np(sj[key])):
                    np.testing.assert_array_equal(a, b, err_msg=path)
                assert t_opt.tree_leaves(state[key])[0].dtype == to.init(pt)["m"]["w"].dtype
        assert int(st["t"]) == int(si["t"]) == int(sj["t"]) == len(grads)


def test_synthetic_lm_task_and_batch_iterator_identical():
    for vocab, seq, seed in [(512, 64, 0), (97, 9, 3)]:
        jt, tt = j_syn.SyntheticLMTask(vocab, seq, seed), t_syn.SyntheticLMTask(vocab, seq, seed)
        rj, rt = np.random.default_rng(5), np.random.default_rng(5)
        for b in (8, 3):
            a, c = jt.sample(b, rj), tt.sample(b, rt)
            assert c.dtype == a.dtype == np.int32
            np.testing.assert_array_equal(a, c)
    x = np.arange(37 * 2, dtype=np.float32).reshape(37, 2)
    y = np.arange(37, dtype=np.int32)
    for bs, epochs in [(8, 1.0), (5, 0.5), (16, 2.3), (4, 0.0)]:
        ja = list(j_syn.batch_iterator(x, y, bs, epochs, np.random.default_rng(2)))
        ta = list(t_syn.batch_iterator(x, y, bs, epochs, np.random.default_rng(2)))
        assert len(ja) == len(ta)
        for (xa, ya), (xb, yb) in zip(ja, ta):
            np.testing.assert_array_equal(xa, xb)
            np.testing.assert_array_equal(ya, yb)


def test_train_loop_matches_jax_over_three_steps(monkeypatch):
    steps, batch, lr, seed = 3, 2, 3e-4, 0
    arch = "recurrentgemma-9b"
    tc, jc = t_configs.smoke_config(arch), j_smoke_config(arch)
    # one init in both loops: the reference's train_loop draws its own with
    # jax.random, op by op (about 6 s of compiles in a fresh process), so
    # here its init_params hands it the port's init instead; the rest of
    # its loop (batches, step, AdamW) runs as it is
    init = TT.init_params(torch.Generator().manual_seed(seed), tc)
    jp = jax.tree.map(jnp.asarray, tree_to_numpy(init))
    monkeypatch.setattr(JT, "init_params", lambda key, cfg: jp)
    tp = tree_from_numpy(tree_to_numpy(init))
    for m in (fa_mod, rg_mod):
        m.reset_launches()
    j_params, j_losses, _ = j_train.train_loop(jc, steps, batch, lr, seed, log_every=0)
    t_params, t_losses, _ = t_train.train_loop(tc, steps, batch, lr, seed, 0, params=tp,
                                               device="cpu")
    np.testing.assert_allclose(t_losses, j_losses, rtol=LOSS_TOL)
    assert t_losses[-1] < t_losses[0]
    apart = total = 0
    for path, a, b in _pairs(tree_to_numpy(t_params), _np(j_params)):
        d = np.abs(a - b)
        assert float(d.max()) <= 2 * steps * lr, path
        apart += int((d > 1e-6).sum())
        total += d.size
    assert apart <= FLIP_SHARE * total, (apart, total)
    # on the CPU no kernel launches, in either direction
    assert not any(v for m in (fa_mod, rg_mod) for d in (m.LAUNCHES, m.BWD_LAUNCHES)
                   for v in d.values())


def test_train_cli_runs_on_cpu_and_refuses_a_missing_card(capsys):
    losses = t_train.main(["--arch", "whisper-small", "--smoke", "--steps", "2", "--batch", "2",
                           "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "[train] whisper-small" in out and "2 steps" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_train.train_loop(t_configs.smoke_config("gemma2-2b"), 1, 1, device="cuda")


def test_trained_params_leave_without_grad():
    # the trainer sets requires_grad on the leaves only for its own grads:
    # the params it returns record no graph in a later forward
    tc = t_configs.smoke_config("gemma2-2b")
    params, losses, _ = t_train.train_loop(tc, 1, 1, log_every=0, device="cpu")
    assert np.isfinite(losses[0])
    assert not any(p.requires_grad for p in t_opt.tree_leaves(params))
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, tc.vocab_size, (1, 5)))
    logits, _ = TT.forward(params, tc, {"tokens": toks})
    assert logits.grad_fn is None
