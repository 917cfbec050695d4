"""The port's encoder-decoder path (whisper-small: the encoder, learned
positions and cross-attention in prefill and decode) against the JAX
package, on the CPU.

Every comparison starts from the JAX package's own init, handed to the port
leaf by leaf through numpy, and from the same numpy inputs.  Bars: the cross
mode of the flash kernel's plain version and the cross-attention layer at
1e-5 (the block bar), ``cross_attention_decode`` at 1e-6 (the layer bar),
the encoder at 1e-5, the whole smoke model through
``tests/torch_llm_parity.whole_model`` (prefill and decode logits 1e-4, the
caches with ``cross_k`` / ``cross_v`` at 1e-5, the forward 1e-4, decode vs
the port's own forward 2e-3).  The reference's encoder is causal
(``repro/models/transformer.py:_run_encoder`` builds its blocks with the
default ``causal=True``), and so is the port's: a witness holds both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import attention as j_attn
from repro.models import transformer as JT
from repro_torch import configs as t_configs
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as TT
from torch_llm_parity import assert_tree_close, whole_model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread beats a pool of them,
    which only contends with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LAYER_TOL = 1e-6
BLOCK_TOL = 1e-5
FRAMES = t_serve.CLI_ENC_FRAMES   # the reference CLI's 16 encoder frames
ARCH = "whisper-small"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _frames(seed, b, t, d):
    """Seeded encoder frames x 0.02, as tests/test_models_smoke.py draws them."""
    return (np.random.default_rng(seed).normal(size=(b, t, d)) * 0.02).astype(np.float32)


def _spec_pair(h, kv, d=64, **kw):
    kw = dict(d_model=h * d, num_heads=h, num_kv_heads=kv, head_dim=d, causal=False, **kw)
    return t_attn.AttnSpec(**kw), j_attn.AttnSpec(**kw)


def _cross_params(seed, js):
    """A cross-attention layer's params from the JAX init, its zero biases
    and norm scales replaced by random values so that every term counts."""
    jp = j_attn.init_attention(jax.random.PRNGKey(seed), js)
    rng = np.random.default_rng(seed)
    return {k: (jnp.asarray(rng.normal(size=v.shape) * 0.5, v.dtype)
                if k in ("bq", "bk", "bv", "q_norm", "k_norm") else v) for k, v in jp.items()}


# (s queries, t keys, heads, kv heads, spec extras): t below and above s and
# off the kernel's 32- and 64-key tiles, s = 1 as in decode, MHA and GQA,
# rope at their own positions, the QKV bias and qk-norm
CROSS_CASES = [
    (24, 16, 4, 4, {"use_rope": False}),
    (7, 45, 4, 4, {"use_rope": False}),
    (1, 33, 4, 2, {"use_rope": False, "qkv_bias": True}),
    (40, 100, 8, 2, {"qk_norm": True}),
    (65, 3, 2, 1, {"qkv_bias": True, "qk_norm": True}),
]


@pytest.mark.parametrize("s,t,h,kv,kw", CROSS_CASES)
def test_cross_attention_prefill_matches_jax(s, t, h, kv, kw):
    ts, js = _spec_pair(h, kv, **kw)
    jp = _cross_params(s * 100 + t, js)
    rng = np.random.default_rng(s + t)
    x = rng.normal(size=(2, s, ts.d_model)).astype(np.float32)
    xkv = rng.normal(size=(2, t, ts.d_model)).astype(np.float32)

    @jax.jit
    def reference(p, a, b):
        qkv = j_attn._project_qkv(p, js, a, b, jnp.arange(s), jnp.arange(t))
        bias = j_attn._mask_bias(js, jnp.arange(s), jnp.arange(t), jnp.float32)
        return qkv, j_attn._sdpa(js, *qkv, bias), j_attn.attention_fwd(p, js, a, xkv=b)

    (q, k, v), j_o, (j_out, (j_k, _)) = reference(jp, jnp.asarray(x), jnp.asarray(xkv))
    # the kernel's plain version on the layer's own q, k, v against the
    # reference's _sdpa under its non-causal mask
    t_o = flash_attention_plain(*(torch.from_numpy(np.array(a)) for a in (q, k, v)), causal=False)
    assert t_o.shape == (2, s, h, 64)
    np.testing.assert_allclose(t_o.numpy(), np.asarray(j_o), atol=BLOCK_TOL, rtol=BLOCK_TOL)
    # the whole layer: projections at their own positions, the kernel, wo
    t_out, (t_k, _) = t_attn.attention_fwd(tree_from_numpy(_np(jp)), ts, torch.from_numpy(x),
                                           xkv=torch.from_numpy(xkv))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=BLOCK_TOL, rtol=BLOCK_TOL)
    np.testing.assert_allclose(t_k.numpy(), np.asarray(j_k), atol=BLOCK_TOL, rtol=BLOCK_TOL)


@pytest.mark.parametrize("t,h,kv,kw", [(16, 4, 4, {"use_rope": False}), (37, 8, 2, {"qkv_bias": True}),
                                       (5, 4, 1, {"qk_norm": True})])
def test_cross_attention_decode_matches_jax(t, h, kv, kw):
    ts, js = _spec_pair(h, kv, **kw)
    jp = _cross_params(t * 7 + h, js)
    rng = np.random.default_rng(t)
    x = rng.normal(size=(3, 1, ts.d_model)).astype(np.float32)
    ek = rng.normal(size=(3, t, kv, 64)).astype(np.float32)
    ev = rng.normal(size=(3, t, kv, 64)).astype(np.float32)
    j_out = jax.jit(lambda p, *a: j_attn.cross_attention_decode(p, js, *a))(
        jp, *(jnp.asarray(a) for a in (x, ek, ev)))
    t_out = t_attn.cross_attention_decode(tree_from_numpy(_np(jp)), ts,
                                          *(torch.from_numpy(a) for a in (x, ek, ev)))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=LAYER_TOL, rtol=LAYER_TOL)


@pytest.fixture(scope="module")
def smoke():
    """The smoke whisper-small from the JAX init, on both sides."""
    tc, jc = t_configs.smoke_config(ARCH), j_smoke_config(ARCH)
    jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(3), jc)
    return tc, jc, jp, tree_from_numpy(_np(jp))


def test_encoder_matches_jax_and_is_causal_like_the_reference(smoke):
    tc, jc, jp, tp = smoke
    assert (tc.encoder_layers, tc.pos_embed) == (2, "learned")
    frames = _frames(5, 2, FRAMES, tc.d_model)
    cut = frames.copy()
    cut[:, 10:] = 0.0
    j_enc = jax.jit(lambda p, e: JT._run_encoder(p, jc, e))
    j_out, j_cut = np.asarray(j_enc(jp, frames)), np.asarray(j_enc(jp, cut))
    t_out = TT._run_encoder(tp, tc, torch.from_numpy(frames)).numpy()
    t_cut = TT._run_encoder(tp, tc, torch.from_numpy(cut)).numpy()
    np.testing.assert_allclose(t_out, j_out, atol=BLOCK_TOL, rtol=BLOCK_TOL)
    np.testing.assert_allclose(t_cut, j_cut, atol=BLOCK_TOL, rtol=BLOCK_TOL)
    # zeroing frames 10-15 leaves frames 0-9 exactly where they were, in the
    # reference and in the port; the later frames move
    for out, cut_out in ((j_out, j_cut), (t_out, t_cut)):
        assert np.abs(out[:, :10] - cut_out[:, :10]).max() == 0.0
        assert np.abs(out[:, 10:] - cut_out[:, 10:]).max() > 1e-2


def test_init_and_decode_state_trees_match_jax(smoke):
    tc, jc, jp, _ = smoke
    tp = TT.init_params(torch.Generator().manual_seed(0), tc)
    shapes = lambda tree: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)
    assert shapes(tree_to_numpy(tp)) == shapes(_np(jp))
    assert tp["pos_embed"].shape == tp["enc_pos"].shape == (tc.max_position, tc.d_model)
    assert set(tp["blocks"]["s0"]) == {"ln1", "attn", "ln2", "ffn", "lnx", "xattn"}
    ts = TT.init_decode_state(tc, 2, 40, FRAMES)
    js = JT.init_decode_state(jc, 2, 40, FRAMES)
    assert ts["pos"] == int(js["pos"]) == 0
    assert_tree_close(tree_to_numpy(ts["caches"]), _np(js["caches"]), 0.0)
    assert ts["caches"]["blocks"]["s0"]["cross_k"].shape == (tc.num_layers, 2, FRAMES,
                                                             tc.num_kv_heads, 64)


def test_whisper_prefill_decode_serve_match_jax():
    """A 12-token prompt against 16 frames: cross prefill with more keys
    than queries, cross decode with one query."""
    tc, jc = t_configs.smoke_config(ARCH), j_smoke_config(ARCH)
    whole_model(tc, jc, prompt_len=12, new_tokens=4, seed=6,
                extra={"enc_embeds": _frames(6, 2, FRAMES, tc.d_model)})


def test_encoder_decoder_needs_its_frames(smoke):
    tc, _, _, tp = smoke
    tokens = torch.zeros(1, 4, dtype=torch.long)
    for call in (lambda: TT.prefill(tp, tc, {"tokens": tokens}),
                 lambda: TT.forward(tp, tc, {"tokens": tokens}),
                 lambda: t_serve.serve_batch(tc, tp, tokens, 1, device="cpu")):
        with pytest.raises(ValueError, match="enc_embeds"):
            call()


def test_serve_cli_and_example_run_whisper_on_cpu(capsys):
    fa_mod.reset_launches()
    out = t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "8", "--new-tokens", "3"])
    assert tuple(out.shape) == (2, 3)
    assert f"[serve] {ARCH} retention=1.0 on cpu" in capsys.readouterr().out
    assert not any(fa_mod.LAUNCHES.values())
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_serve_decode.py"
    spec = importlib.util.spec_from_file_location("torch_serve_decode", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--new-tokens", "3"])
    printed = capsys.readouterr().out
    assert f"[serve] {ARCH} gamma=1.0" in printed and f"[serve] {ARCH} gamma=0.5" in printed
