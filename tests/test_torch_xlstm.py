"""The port's xLSTM cells (``models/xlstm.py``, kinds ``mlstm`` and ``slstm``)
and xlstm-1.3b's smoke config against the JAX package, on the CPU.

Both packages start from the JAX init, handed to the port leaf by leaf
through numpy, and from the same numpy inputs.  Bars: block outputs and the
mLSTM's decode state ``(C, n, m)`` at 1e-5 in both branches of the parallel
form (whole, and row-blocked when ``t_block`` divides ``s``), then a few
recurrent decode steps at 1e-5; whole-model logits at 1e-4 with identical
greedy tokens (the caches at ``STATE_TOL``, below), and the port's decode
against its own forward at 2e-3.

The sLSTM's two recurrences go through ``kernels.rg_lru_scan`` (its plain
sequential loop on the CPU) where JAX runs ``jax.lax.associative_scan``, a
tree that rounds differently.  Measured on this test's inputs and three
more shapes (s = 100 to 2000, d_inner 128 and 256): the sequential and the
tree-ordered scans differ by at most 4.2e-7 of max|state| (the state ``n``
reaches ~40), the sequential one lies within 3.4e-7 of a float64 loop and
the tree within 1.5e-7.  ``SCAN_REL_TOL`` = 1e-6 of max|state| holds both
the port against JAX and the port against float64; the block's output
(|out| ~ 0.6) stays within 1e-5.  The ``cuda``-marked twin holds the
sLSTM's one scan launch against the plain version on the card.  The JAX
package is imported by the ``J`` fixture, not by the module, so that the
twin also runs where JAX is absent: ``python -m pytest -m cuda
tests/test_torch_xlstm.py`` on the card.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.kernels import rg_lru_scan as rg_mod
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as t_xlstm
from repro_torch.models.config import apply_retention as t_apply_retention
from repro_torch.models.config import param_count as t_param_count

BLOCK_TOL = 1e-5
SCAN_REL_TOL = 1e-6
# the whole smoke model's decode caches after prefill: its sLSTM state is
# fed gates that already differ by ~1e-6 after the mLSTM layer, and the
# scan's rounding carries them; measured at most 3.24e-5 (2.1e-6 of max|c|
# = 15.7) over seeds 21-23 in both branches of the parallel form
STATE_TOL = 5e-5
DECODE_TOL = 2e-3
ARCH = "xlstm-1.3b"


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules used here, and the parity helpers."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import torch_llm_parity
    from repro.configs import smoke_config
    from repro.models import transformer, xlstm

    return types.SimpleNamespace(jax=jax, jnp=jnp, smoke_config=smoke_config, T=transformer,
                                 xlstm=xlstm, parity=torch_llm_parity)


def _np(J, tree):
    return J.jax.tree.map(np.asarray, tree)


def _port(J, tree):
    return tree_from_numpy(_np(J, tree))


def _t(a):
    return torch.from_numpy(np.array(a))


def _spec_pair(J, t_block=None, d_model=64):
    return (t_xlstm.XLSTMSpec(d_model, 4, 2.0, t_block),
            J.xlstm.XLSTMSpec(d_model, 4, 2.0, t_block))


@pytest.mark.parametrize("t_block", [None, 8])
def test_mlstm_fwd_state_and_decode_match_jax(J, t_block):
    """The whole parallel form (t_block None) and the row-blocked one (s = 32
    in four blocks of 8), the state handed to decode, then three steps."""
    jax, jnp, j_xlstm, assert_tree_close = J.jax, J.jnp, J.xlstm, J.parity.assert_tree_close
    ts, js = _spec_pair(J, t_block)
    jp = j_xlstm.init_mlstm(jax.random.PRNGKey(1), js)
    tp = _port(J, jp)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 64)).astype(np.float32)
    out, state = t_xlstm.mlstm_fwd(tp, ts, _t(x))
    j_out, j_state = jax.jit(lambda p, v: j_xlstm.mlstm_fwd(p, js, v))(jp, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=BLOCK_TOL, rtol=BLOCK_TOL)
    assert_tree_close(tree_to_numpy(state), _np(J, j_state), BLOCK_TOL)
    assert tuple(state["C"].shape) == (2, 4, ts.head_dim, ts.head_dim)
    if t_block:
        whole, _ = t_xlstm.mlstm_fwd(tp, t_xlstm.XLSTMSpec(64, 4, 2.0), _t(x))
        np.testing.assert_allclose(out.numpy(), whole.numpy(), atol=BLOCK_TOL, rtol=BLOCK_TOL)
    j_step = jax.jit(lambda p, v, st: j_xlstm.mlstm_decode(p, js, v, st))
    for step in range(3):
        xt = rng.normal(size=(2, 1, 64)).astype(np.float32)
        out, state = t_xlstm.mlstm_decode(tp, ts, _t(xt), state)
        j_out, j_state = j_step(jp, jnp.asarray(xt), j_state)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=BLOCK_TOL, rtol=BLOCK_TOL,
                                   err_msg=f"step {step}")
        assert_tree_close(tree_to_numpy(state), _np(J, j_state), BLOCK_TOL)


def test_slstm_scan_against_associative_scan_and_float64_then_decode(J):
    jax, jnp, j_xlstm, assert_tree_close = J.jax, J.jnp, J.xlstm, J.parity.assert_tree_close
    ts, js = _spec_pair(J)
    jp = j_xlstm.init_slstm(jax.random.PRNGKey(2), js)
    tp = _port(J, jp)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 400, 64)).astype(np.float32)
    rg_mod.reset_launches()
    out, state = t_xlstm.slstm_fwd(tp, ts, _t(x))
    assert not any(rg_mod.LAUNCHES.values())                     # the CPU runs the plain loop
    j_out, j_state = jax.jit(lambda p, v: j_xlstm.slstm_fwd(p, js, v))(jp, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=BLOCK_TOL, rtol=BLOCK_TOL)
    # the two recurrences in float64 from JAX's own gates
    z, i_pre, f_pre, _ = j_xlstm._slstm_pre(jp, jnp.asarray(x))
    f = np.asarray(jnp.exp(jax.nn.log_sigmoid(f_pre)), np.float64)
    i = jnp.exp(jnp.minimum(i_pre, 10.0))
    iz, i = np.asarray(i * z, np.float64), np.asarray(i, np.float64)
    ref = {"c": np.zeros((2, ts.d_inner)), "n": np.zeros((2, ts.d_inner))}
    for t in range(x.shape[1]):
        ref = {"c": f[:, t] * ref["c"] + iz[:, t], "n": f[:, t] * ref["n"] + i[:, t]}
    for k in ("c", "n"):
        scale = np.abs(ref[k]).max()
        port, jx = state[k].numpy().astype(np.float64), np.asarray(j_state[k], np.float64)
        errs = {"port_vs_jax": np.abs(port - jx).max() / scale,
                "port_vs_f64": np.abs(port - ref[k]).max() / scale,
                "jax_vs_f64": np.abs(jx - ref[k]).max() / scale}
        assert errs["port_vs_jax"] <= SCAN_REL_TOL and errs["port_vs_f64"] <= SCAN_REL_TOL, (k, errs)
    j_step = jax.jit(lambda p, v, st: j_xlstm.slstm_decode(p, js, v, st))
    for step in range(3):
        xt = rng.normal(size=(2, 1, 64)).astype(np.float32)
        out, state = t_xlstm.slstm_decode(tp, ts, _t(xt), state)
        j_out, j_state = j_step(jp, jnp.asarray(xt), j_state)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=BLOCK_TOL, rtol=BLOCK_TOL,
                                   err_msg=f"step {step}")
        assert_tree_close(tree_to_numpy(state), _np(J, j_state), BLOCK_TOL)


def test_slstm_recurrence_never_leaves_its_device():
    """On a device other than the CPU or a card the scan raises: no quiet
    fallback to the plain loop."""
    ts = t_xlstm.XLSTMSpec(64, 4, 2.0)
    tp = t_xlstm.init_slstm(torch.Generator().manual_seed(0), ts)
    meta = {k: v.to("meta") for k, v in tp.items()}
    with pytest.raises(ValueError, match="rg_lru_scan runs on CPU or CUDA tensors"):
        t_xlstm.slstm_fwd(meta, ts, torch.zeros(1, 5, 64, device="meta"))


# ---------------------------------------------------------------------------
# the smoke arch as a whole: prefill, decode and serve against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t_block", [None, 8])
def test_xlstm_prefill_decode_serve_match_jax(J, t_block):
    """Smoke xlstm-1.3b (mlstm, slstm); with ``attn_q_block`` 8 the 40-token
    prefill takes the row-blocked branch and the 45-token forward the
    whole one, as the card's 3072-token prefill and 3104-token forward do
    at the config's 1024."""
    tc = t_configs.smoke_config(ARCH).replace(attn_q_block=t_block)
    jc = J.smoke_config(ARCH).replace(attn_q_block=t_block)
    assert tc.block_pattern == ("mlstm", "slstm") and tc.d_ff == 0
    assert J.parity.whole_model(tc, jc, prompt_len=40, new_tokens=5, seed=21, cache_tol=STATE_TOL) == 0.0


def test_init_and_decode_state_trees_match_jax(J):
    jax, JT = J.jax, J.T
    tc, jc = t_configs.smoke_config(ARCH), J.smoke_config(ARCH)
    tp = TT.init_params(torch.Generator().manual_seed(0), tc)
    jp = jax.eval_shape(lambda k: JT.init_params(k, jc), jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp) == \
        TT.tree_map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), tp)
    ts = TT.init_decode_state(tc, 2, 40)
    js = JT.init_decode_state(jc, 2, 40)
    J.parity.assert_tree_close(tree_to_numpy(ts["caches"]), _np(J, js["caches"]), 0.0)
    C = ts["caches"]["blocks"]["s0"]["C"]
    assert C.dtype == torch.float32 and tuple(C.shape) == (1, 2, 4, 64, 64)


# ---------------------------------------------------------------------------
# twins of tests/test_models_smoke.py on the port, from its own init
# ---------------------------------------------------------------------------

def _smoke_batch(cfg, seed, b=2, s=24):
    gen = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen)}


@pytest.mark.parametrize("arch", [ARCH])
def test_decode_matches_forward(arch):
    cfg = t_configs.smoke_config(arch)
    params = TT.init_params(torch.Generator().manual_seed(1), cfg)
    toks = _smoke_batch(cfg, 1)["tokens"]
    full_logits, _ = TT.forward(params, cfg, {"tokens": toks})
    s0 = toks.shape[1] - 4
    lg, state = TT.prefill(params, cfg, {"tokens": toks[:, :s0]}, max_len=64)
    errs = [float((lg - full_logits[:, s0 - 1]).abs().max())]
    for i in range(s0, toks.shape[1]):
        lg, state = TT.decode_step(params, cfg, state, toks[:, i])
        errs.append(float((lg - full_logits[:, i]).abs().max()))
    assert max(errs) < DECODE_TOL, f"incremental decode diverged: {errs}"


@pytest.mark.parametrize("arch", [ARCH])
def test_apply_retention_shrinks(arch):
    cfg = t_configs.smoke_config(arch)
    sub_cfg = t_apply_retention(cfg, 0.5, prune_heads=True)
    assert t_param_count(sub_cfg) < t_param_count(cfg)
    assert sub_cfg.num_heads % sub_cfg.num_kv_heads == 0
    assert sub_cfg.xlstm_proj_factor < cfg.xlstm_proj_factor
    params = TT.init_params(torch.Generator().manual_seed(2), sub_cfg)
    logits, _ = TT.forward(params, sub_cfg, _smoke_batch(sub_cfg, 2))
    assert logits.shape == (2, 24, sub_cfg.vocab_size) and bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# on the card: the sLSTM's scan launch against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_slstm_launches_the_scan_once_and_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the scan kernel builds with nvcc and runs only on the card")
    ts = t_xlstm.XLSTMSpec(96, 4, 2.0)
    tp = t_xlstm.init_slstm(torch.Generator().manual_seed(0), ts)
    x = torch.randn(2, 300, 96, generator=torch.Generator().manual_seed(1))
    cpu_out, cpu_state = t_xlstm.slstm_fwd(tp, ts, x)
    rg_mod.reset_launches()
    out, state = t_xlstm.slstm_fwd(TT.tree_map(lambda t: t.cuda(), tp), ts, x.cuda())
    assert rg_mod.LAUNCHES == {"rg_lru_scan": 1, "rg_lru_scan_bf16": 0}
    torch.testing.assert_close(out.cpu(), cpu_out, atol=BLOCK_TOL, rtol=BLOCK_TOL)
    for k in ("c", "n"):
        torch.testing.assert_close(state[k].cpu(), cpu_state[k], atol=BLOCK_TOL, rtol=BLOCK_TOL)
