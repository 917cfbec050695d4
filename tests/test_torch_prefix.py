"""The port's vision-prefix path (internvl2-76b: ``num_prefix_embeds``
embeddings in front of the tokens) against the JAX package, on the CPU.

Every comparison starts from the JAX package's own init, handed to the port
leaf by leaf through numpy, and from the same numpy inputs.  The whole smoke
model goes through ``tests/torch_llm_parity.whole_model`` with the prefix in
every batch: prefill and decode logits at 1e-4 at a cache that holds prefix,
prompt and new tokens (``P + s + new``), caches at 1e-5, the forward (which
drops the prefix's positions) at 1e-4, and the port's ``serve_batch`` within
2e-3 of its own forward.  The reference's ``serve_batch`` sizes its cache as
``s + new`` (``repro/launch/serve.py:33``): with ``P > new`` the ring drops
the oldest positions, the prefix first, and decode leaves the forward.  A
witness holds that for the reference and shows the port doing the same at
the same explicit capacity, while the port's ``serve_batch`` counts the
prefix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import transformer as JT
from repro_torch import configs as t_configs
from repro_torch.convert import tree_from_numpy
from repro_torch.launch import serve as t_serve
from repro_torch.models import transformer as TT
from torch_llm_parity import whole_model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread beats a pool of them,
    which only contends with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOGIT_TOL = 1e-4
DECODE_TOL = 2e-3
ARCH = "internvl2-76b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _prefix(seed, b, p, d):
    """Seeded prefix embeddings x 0.02, as tests/test_models_smoke.py draws them."""
    return (np.random.default_rng(seed).normal(size=(b, p, d)) * 0.02).astype(np.float32)


def test_internvl_prefill_decode_serve_match_jax():
    tc, jc = t_configs.smoke_config(ARCH), j_smoke_config(ARCH)
    assert tc.num_prefix_embeds == 8 and tc.pos_embed == "rope"
    whole_model(tc, jc, prompt_len=24, new_tokens=4, seed=7,
                extra={"prefix_embeds": _prefix(7, 2, tc.num_prefix_embeds, tc.d_model)})


@pytest.fixture(scope="module")
def smoke():
    tc, jc = t_configs.smoke_config(ARCH), j_smoke_config(ARCH)
    jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(8), jc)
    return tc, jc, jp, tree_from_numpy(_np(jp))


def test_forward_drops_the_prefix_and_the_prefix_counts(smoke):
    tc, _, _, tp = smoke
    toks = torch.as_tensor(np.random.default_rng(8).integers(0, tc.vocab_size, size=(2, 20)))
    pre = torch.from_numpy(_prefix(8, 2, tc.num_prefix_embeds, tc.d_model))
    with_prefix, _ = TT.forward(tp, tc, {"tokens": toks, "prefix_embeds": pre})
    without, _ = TT.forward(tp, tc, {"tokens": toks})
    assert with_prefix.shape == without.shape == (2, 20, tc.vocab_size)
    assert float((with_prefix - without).abs().max()) > 1e-2
    # the prefill's last logits are the forward's last text position's
    last, state = TT.prefill(tp, tc, {"tokens": toks, "prefix_embeds": pre})
    assert state["pos"] == 20 + tc.num_prefix_embeds
    torch.testing.assert_close(last, with_prefix[:, -1], atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_reference_serve_capacity_evicts_the_prefix_and_the_port_serve_does_not(smoke):
    """At the reference serve's capacity ``s + new`` (P 8 > new 4) both
    packages' decodes leave their forward far beyond 2e-3, and agree with
    each other at 1e-4; at ``P + s + new`` the reference's decode stays
    within 2e-3, as does the port's ``serve_batch``."""
    tc, jc, jp, tp = smoke
    P, s, n = tc.num_prefix_embeds, 24, 4
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, tc.vocab_size, size=(2, s))
    pre = _prefix(9, 2, P, tc.d_model)
    gen = t_serve.serve_batch(tc, tp, torch.as_tensor(prompts), n, {"prefix_embeds": torch.from_numpy(pre)},
                              device="cpu")
    toks = np.concatenate([prompts, gen.numpy()], axis=1)
    j_full = np.asarray(jax.jit(lambda p, t, x: JT.forward(p, jc, {"tokens": t, "prefix_embeds": x})[0])(
        jp, jnp.asarray(toks, jnp.int32), jnp.asarray(pre)))[:, s - 1:]

    def reference_decode(max_len):
        step = jax.jit(lambda p, st, tok: JT.decode_step(p, jc, st, tok))
        logits, st = jax.jit(lambda p, t, x: JT.prefill(p, jc, {"tokens": t, "prefix_embeds": x},
                                                        max_len=max_len))(
            jp, jnp.asarray(prompts, jnp.int32), jnp.asarray(pre))
        out = [np.asarray(logits)]
        for i in range(n):
            logits, st = step(jp, st, jnp.asarray(toks[:, s + i], jnp.int32))
            out.append(np.asarray(logits))
        return np.stack(out, axis=1)

    def port_decode(max_len):
        logits, st = TT.prefill(tp, tc, {"tokens": torch.as_tensor(prompts),
                                         "prefix_embeds": torch.from_numpy(pre)}, max_len=max_len)
        out = [logits.numpy()]
        for i in range(n):
            logits, st = TT.decode_step(tp, tc, st, torch.as_tensor(toks[:, s + i]))
            out.append(logits.numpy())
        return np.stack(out, axis=1)

    evicted, kept = reference_decode(s + n), reference_decode(P + s + n)
    assert np.abs(evicted[:, 1:] - j_full[:, 1:]).max() > 0.1
    assert np.abs(kept - j_full).max() < DECODE_TOL
    np.testing.assert_allclose(port_decode(s + n), evicted, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    _, t_all = t_serve.serve_batch(tc, tp, torch.as_tensor(prompts), n,
                                   {"prefix_embeds": torch.from_numpy(pre)}, device="cpu",
                                   return_logits=True)
    assert np.abs(t_all.numpy() - j_full).max() < DECODE_TOL


def test_serve_cli_and_example_run_internvl_on_cpu(capsys):
    out = t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "8", "--new-tokens", "3"])
    assert tuple(out.shape) == (2, 3)
    assert f"[serve] {ARCH} retention=1.0 on cpu" in capsys.readouterr().out
    extra = t_serve.extra_inputs(t_configs.smoke_config(ARCH), 2, "cpu")
    assert set(extra) == {"prefix_embeds"} and extra["prefix_embeds"].shape == (2, 8, 256)
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_serve_decode.py"
    spec = importlib.util.spec_from_file_location("torch_serve_decode", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--new-tokens", "3"])
    printed = capsys.readouterr().out
    assert f"[serve] {ARCH} gamma=1.0" in printed and f"[serve] {ARCH} gamma=0.5" in printed
