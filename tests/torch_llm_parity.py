"""One whole-model parity run of the port's LLM path against the JAX package
(imported by the ``test_torch_*`` files; not a test file itself).

``whole_model`` starts both packages from the JAX init, handed to the port
leaf by leaf through numpy, and from the same numpy prompts, and holds:
prefill logits at 1e-4 and the decode caches at ``cache_tol`` (1e-5 by
default); each decode step's logits at 1e-4 on JAX's greedy token stream;
the port's ``serve_batch`` greedy tokens equal to JAX's; the teacher-forced ``forward`` over prompt +
generated tokens at 1e-4 with its aux loss at 1e-6; and the port's decode
logits within 2e-3 of its own forward (tests/test_models_smoke.py's bar).
``extra`` adds numpy ``enc_embeds`` / ``prefix_embeds`` to every batch; the
cache then holds the prefix too (capacity ``P + prompt_len + new_tokens``,
as the port's ``serve_batch`` sizes it).  Every JAX function runs jitted,
one compile each, to keep the test short.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as JT
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import rg_lru_scan as rg_mod
from repro_torch.launch import serve as t_serve
from repro_torch.models import transformer as TT

BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4
AUX_TOL = 1e-6
DECODE_TOL = 2e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_tree_close(port_tree, jax_tree, tol, path="root"):
    if isinstance(jax_tree, dict):
        assert set(port_tree) == set(jax_tree), path
        for k in jax_tree:
            assert_tree_close(port_tree[k], jax_tree[k], tol, f"{path}.{k}")
    elif isinstance(jax_tree, (list, tuple)):
        assert len(port_tree) == len(jax_tree), path
        for i, (p, j) in enumerate(zip(port_tree, jax_tree)):
            assert_tree_close(p, j, tol, f"{path}[{i}]")
    else:
        p, j = np.asarray(port_tree), np.asarray(jax_tree)
        assert p.shape == j.shape, (path, p.shape, j.shape)
        np.testing.assert_allclose(p, j, atol=tol, rtol=tol, err_msg=path)


def whole_model(tc, jc, prompt_len: int, new_tokens: int, seed: int, cache_tol: float = BLOCK_TOL,
                extra=None):
    """Returns the port's forward aux loss (a float).  ``cache_tol`` bars the
    decode caches (a recurrent state that carries a sequential scan's
    rounding takes a wider, measured one)."""
    jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(seed), jc)
    tp = tree_from_numpy(_np(jp))
    prompts = np.random.default_rng(seed).integers(0, tc.vocab_size, size=(2, prompt_len))
    extra = extra or {}
    t_extra = {k: torch.as_tensor(v) for k, v in extra.items()}
    j_extra = {k: jnp.asarray(v) for k, v in extra.items()}
    s_total = prompt_len + (extra["prefix_embeds"].shape[1] if "prefix_embeds" in extra else 0)
    max_len = s_total + new_tokens
    t_logits, t_state = TT.prefill(tp, tc, {"tokens": torch.as_tensor(prompts), **t_extra},
                                   max_len=max_len)
    j_logits, j_state = jax.jit(lambda p, t, x: JT.prefill(p, jc, {"tokens": t, **x}, max_len=max_len))(
        jp, jnp.asarray(prompts, jnp.int32), j_extra)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert t_state["pos"] == int(j_state["pos"]) == s_total
    assert_tree_close(tree_to_numpy(t_state["caches"]), _np(j_state["caches"]), cache_tol)
    # per-step decode on JAX's greedy token stream
    j_step = jax.jit(lambda p, st, tok: JT.decode_step(p, jc, st, tok))
    tok = np.asarray(jnp.argmax(j_logits, axis=-1)).astype(np.int64)
    j_gen = []
    for i in range(new_tokens):
        j_gen.append(tok)
        t_logits, t_state = TT.decode_step(tp, tc, t_state, torch.as_tensor(tok))
        j_logits, j_state = j_step(jp, j_state, jnp.asarray(tok, jnp.int32))
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"decode step {i}")
        tok = np.asarray(jnp.argmax(j_logits, axis=-1)).astype(np.int64)
    assert_tree_close(tree_to_numpy(t_state["caches"]), _np(j_state["caches"]), cache_tol)
    # serve_batch: JAX's greedy tokens, no kernel launched on the CPU
    for mod in (fa_mod, rg_mod):
        mod.reset_launches()
    t_gen, t_all = t_serve.serve_batch(tc, tp, torch.as_tensor(prompts), new_tokens, t_extra,
                                       device="cpu", return_logits=True)
    np.testing.assert_array_equal(t_gen.numpy(), np.stack(j_gen, axis=1))
    assert not any(v for m in (fa_mod, rg_mod) for v in m.LAUNCHES.values())
    # forward over prompt + generated: logits and aux against JAX, and the
    # port's decode against its own forward
    toks = torch.cat([torch.as_tensor(prompts), t_gen], dim=1)
    full, t_aux = TT.forward(tp, tc, {"tokens": toks, **t_extra})
    j_full, j_aux = jax.jit(lambda p, t, x: JT.forward(p, jc, {"tokens": t, **x}))(
        jp, jnp.asarray(toks.numpy(), jnp.int32), j_extra)
    np.testing.assert_allclose(full.numpy(), np.asarray(j_full), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), atol=AUX_TOL, rtol=AUX_TOL)
    ref = full[:, prompt_len - 1:]
    assert t_all.shape == ref.shape == (2, new_tokens + 1, tc.vocab_size)
    assert float((t_all - ref).abs().max()) < DECODE_TOL
    return float(t_aux)
