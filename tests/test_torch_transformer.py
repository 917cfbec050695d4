"""The port's LLM serving path against the JAX package, on the CPU.

Every comparison starts from the JAX package's own init
(``T.init_params(jax.random.PRNGKey(s), cfg)``), handed to the port leaf by
leaf through numpy (``convert.tree_from_numpy``), and from the same numpy
inputs.  Layers are held at 1e-6, block modules at 1e-5, whole-model logits
at 1e-4 (f32 summation order through several layers), greedy tokens
exactly; the port's own decode-vs-forward consistency at 2e-3, the bar of
tests/test_models_smoke.py.  On the CPU the flash-attention and RG-LRU
wrappers run their plain versions (tests/test_torch_llm_kernels.py holds
those against the Pallas kernels).  The whole-model runs go through
``tests/torch_llm_parity.whole_model``, shared with the MoE and xLSTM files.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import smoke_config as j_smoke_config
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import rglru as j_rglru
from repro.models import transformer as JT
from repro.models.config import apply_retention as j_apply_retention
from repro.models.config import flops_per_token as j_flops_per_token
from repro.models.config import param_count as j_param_count
from repro_torch import configs as t_configs
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import rg_lru_scan as rg_mod
from repro_torch.launch import serve as t_serve
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import rglru as t_rglru
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.models.config import apply_retention as t_apply_retention
from repro_torch.models.config import flops_per_token as t_flops_per_token
from repro_torch.models.config import param_count as t_param_count
from torch_llm_parity import assert_tree_close, whole_model

LAYER_TOL = 1e-6
BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4
DECODE_TOL = 2e-3
ARCHS = ["recurrentgemma-9b", "gemma2-2b", "internlm2-1.8b", "qwen1.5-32b", "qwen3-32b",
         "granite-moe-1b-a400m", "llama4-maverick-400b-a17b", "xlstm-1.3b", "whisper-small",
         "internvl2-76b"]
# the dense attention archs: GQA 16/8 and 64/8, MHA 40/40 with a QKV bias,
# qk-norm, rope_theta 1e6
DENSE = ["internlm2-1.8b", "qwen1.5-32b", "qwen3-32b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return tree_from_numpy(_np(tree))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rgemma_cfg(window=32):
    """Smoke recurrentgemma at 4 layers: one (rglru, rglru, local) group plus
    one remainder rglru layer, so both ``blocks`` and ``rem`` are used."""
    kw = dict(num_layers=4, block_pattern=("rglru", "rglru", "local"), window_size=window)
    return t_configs.smoke_config("recurrentgemma-9b").replace(**kw), \
        j_smoke_config("recurrentgemma-9b").replace(**kw)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_retention_and_counts_match_jax(arch, smoke):
    tc = t_configs.smoke_config(arch) if smoke else t_configs.get_config(arch)
    jc = j_smoke_config(arch) if smoke else j_get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert t_param_count(tc) == j_param_count(jc)
    assert t_flops_per_token(tc, 4096) == j_flops_per_token(jc, 4096)
    for gamma in (0.5, 0.25):
        ts, js = t_apply_retention(tc, gamma), j_apply_retention(jc, gamma)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert t_param_count(ts) == j_param_count(js)


def test_full_size_recurrentgemma_layout():
    cfg = t_configs.get_config("recurrentgemma-9b")
    g, rem = TT._split_layers(cfg)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads) == (38, 4096, 16, 1)
    assert (g, rem) == (12, ["rglru", "rglru"])
    kinds = cfg.layer_kinds()
    assert kinds.count("local") == 12 and kinds.count("rglru") == 26
    assert t_configs.list_archs() == ["gemma2-2b", "granite-moe-1b-a400m", "internlm2-1.8b",
                                      "internvl2-76b", "llama4-maverick-400b-a17b", "qwen1.5-32b",
                                      "qwen3-32b", "recurrentgemma-9b", "whisper-small",
                                      "xlstm-1.3b"]


def test_unported_arch_is_refused_by_name():
    """Every arch of the reference is registered now (whisper-small and
    internvl2-76b since slice 17); an unknown name is refused by name."""
    assert not hasattr(t_configs.base, "UNPORTED_ARCHS")
    assert t_configs.list_archs() == sorted(j_list_archs())
    whisper, internvl = t_configs.get_config("whisper-small"), t_configs.smoke_config("internvl2-76b")
    assert (whisper.encoder_layers, whisper.pos_embed) == (12, "learned")
    assert internvl.num_prefix_embeds == 8
    with pytest.raises(ValueError, match=r"no-such-arch"):
        t_configs.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# init and conversion
# ---------------------------------------------------------------------------

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), str(np.dtype(str(tree.dtype).replace("torch.", ""))))


@pytest.mark.parametrize("which", ["recurrentgemma-4l", "recurrentgemma-9b", "gemma2-2b",
                                   "granite-moe-1b-a400m", "llama4-maverick-400b-a17b",
                                   "xlstm-1.3b", "whisper-small", "internvl2-76b"])
def test_init_params_tree_shapes_dtypes_match_jax(which):
    if which == "recurrentgemma-4l":
        tc, jc = _rgemma_cfg()
    else:
        tc, jc = t_configs.smoke_config(which), j_smoke_config(which)
    tp = TT.init_params(torch.Generator().manual_seed(0), tc)
    jp = JT.init_params(jax.random.PRNGKey(0), jc)
    assert _shapes(tp) == _shapes(_np(jp))


@pytest.mark.parametrize("which", ["recurrentgemma-4l", "gemma2-2b"])
def test_init_decode_state_matches_jax(which):
    if which == "recurrentgemma-4l":
        tc, jc = _rgemma_cfg()
    else:
        tc, jc = t_configs.smoke_config(which), j_smoke_config(which)
    ts = TT.init_decode_state(tc, 2, 40)
    js = JT.init_decode_state(jc, 2, 40)
    assert ts["pos"] == int(js["pos"]) == 0
    assert_tree_close(tree_to_numpy(ts["caches"]), _np(js["caches"]), 0.0)


def test_init_is_seeded_and_lambda_in_range():
    tc, _ = _rgemma_cfg()
    a = TT.init_params(torch.Generator().manual_seed(3), tc)
    b = TT.init_params(torch.Generator().manual_seed(3), tc)
    torch.testing.assert_close(a["blocks"]["s0"]["rglru"]["w_x"], b["blocks"]["s0"]["rglru"]["w_x"],
                               rtol=0, atol=0)
    lam = a["blocks"]["s0"]["rglru"]["lam"]
    decay = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert float(decay.min()) > 0.9 - 1e-6 and float(decay.max()) < 0.999 + 1e-6
    w = a["blocks"]["s0"]["ffn"]["w_up"]
    bound = 2.0 / np.sqrt(tc.d_model)
    assert float(w.abs().max()) <= bound * (1 + 1e-6)
    assert abs(float(w.std()) * np.sqrt(tc.d_model) - 0.88) < 0.05   # truncated at 2 sigma


def test_tree_numpy_round_trip():
    tc, _ = _rgemma_cfg()
    tp = TT.init_params(torch.Generator().manual_seed(1), tc)
    back = tree_from_numpy(tree_to_numpy(tp))
    assert_tree_close(back, tree_to_numpy(tp), 0.0)
    state = {"caches": {"rem": [{"pos": torch.arange(3, dtype=torch.int32)}]}, "pos": 5}
    arr = tree_to_numpy(state)
    assert arr["pos"] == 5 and arr["caches"]["rem"][0]["pos"].dtype == np.int32
    assert tree_from_numpy(arr["caches"])["rem"][0]["pos"].dtype == torch.int32


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32) * 3
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    bias = rng.normal(size=(64,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(t_layers.rms_norm(_t(x), _t(scale)).numpy(),
                               np.asarray(j_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
                               atol=LAYER_TOL, rtol=LAYER_TOL)
    np.testing.assert_allclose(
        t_layers.layer_norm(_t(x), _t(scale + 1), _t(bias)).numpy(),
        np.asarray(j_layers.layer_norm(jnp.asarray(x), jnp.asarray(scale + 1), jnp.asarray(bias))),
        atol=LAYER_TOL, rtol=LAYER_TOL)
    pos = np.arange(7) + 3000
    ts, tc = t_layers.rotary_embedding(_t(pos), 64)
    js, jc = j_layers.rotary_embedding(jnp.asarray(pos), 64)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=LAYER_TOL, rtol=LAYER_TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=LAYER_TOL, rtol=LAYER_TOL)
    np.testing.assert_allclose(t_layers.apply_rope(_t(x), ts, tc).numpy(),
                               np.asarray(j_layers.apply_rope(jnp.asarray(x), js, jc)),
                               atol=LAYER_TOL, rtol=LAYER_TOL)
    np.testing.assert_allclose(t_layers.gelu(_t(x)).numpy(), np.asarray(j_layers.gelu(jnp.asarray(x))),
                               atol=LAYER_TOL, rtol=LAYER_TOL)
    np.testing.assert_allclose(t_layers.silu(_t(x)).numpy(), np.asarray(j_layers.silu(jnp.asarray(x))),
                               atol=LAYER_TOL, rtol=LAYER_TOL)
    for cap in (None, 5.0):
        np.testing.assert_allclose(t_layers.softcap(_t(x), cap).numpy(),
                                   np.asarray(j_layers.softcap(jnp.asarray(x), cap)),
                                   atol=LAYER_TOL, rtol=LAYER_TOL)


# ---------------------------------------------------------------------------
# block modules, from the same converted params
# ---------------------------------------------------------------------------

def _spec_pair(window, cap, heads=4, kv=1, qk_norm=False, qkv_bias=False):
    kw = dict(d_model=128, num_heads=heads, num_kv_heads=kv, head_dim=64, logit_softcap=cap,
              window=window, qk_norm=qk_norm, qkv_bias=qkv_bias)
    return t_attn.AttnSpec(**kw), j_attn.AttnSpec(**kw)


@pytest.mark.parametrize("window,cap,heads,kv,extra", [
    (16, None, 4, 1, {}),
    (None, None, 4, 2, {}),
    (None, 50.0, 4, 4, {}),
    (24, 30.0, 4, 1, {"qk_norm": True, "qkv_bias": True}),
])
def test_attention_fwd_matches_jax(window, cap, heads, kv, extra):
    ts, js = _spec_pair(window, cap, heads, kv, **extra)
    jp = j_attn.init_attention(jax.random.PRNGKey(heads + kv), js)
    if extra:
        # non-zero biases and norm scales, so those paths are exercised
        jp = {k: (v + 0.1 if k in ("bq", "bk", "bv", "q_norm", "k_norm") else v) for k, v in jp.items()}
    x = np.random.default_rng(1).normal(size=(2, 50, 128)).astype(np.float32)
    out, (k, v) = t_attn.attention_fwd(_port(jp), ts, _t(x))
    j_out, (jk, jv) = j_attn.attention_fwd(jp, js, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=BLOCK_TOL, rtol=BLOCK_TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=BLOCK_TOL, rtol=BLOCK_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=BLOCK_TOL, rtol=BLOCK_TOL)


@pytest.mark.parametrize("window,cap", [(16, None), (16, 50.0), (None, None)])
def test_attention_decode_over_wrapped_ring_matches_jax(window, cap):
    ts, js = _spec_pair(window, cap)
    jp = j_attn.init_attention(jax.random.PRNGKey(7), js)
    tp = _port(jp)
    L = 40
    tcache = t_attn.init_cache(ts, 2, L)
    jcache = j_attn.init_cache(js, 2, L, jnp.float32)
    xs = np.random.default_rng(2).normal(size=(40, 2, 1, 128)).astype(np.float32)
    j_step = jax.jit(lambda c, x, p: j_attn.attention_decode(jp, js, x, c, p))
    for pos in range(40):                      # 40 steps: a 16-slot ring wraps twice
        out, tcache = t_attn.attention_decode(tp, ts, _t(xs[pos]), tcache, pos)
        j_out, jcache = j_step(jcache, jnp.asarray(xs[pos]), jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=BLOCK_TOL, rtol=BLOCK_TOL)
    assert tcache["k"].shape[1] == (16 if window else L)
    assert_tree_close(tcache, _np(jcache), BLOCK_TOL)


def test_rglru_fwd_and_decode_match_jax():
    kw = dict(d_model=128, d_rnn=128, num_heads=4)
    ts, js = t_rglru.RGLRUSpec(**kw), j_rglru.RGLRUSpec(**kw)
    jp = j_rglru.init_rglru(jax.random.PRNGKey(3), js)
    tp = _port(jp)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 45, 128)).astype(np.float32)
    out, state = t_rglru.rglru_fwd(tp, ts, _t(x))
    j_out, j_state = j_rglru.rglru_fwd(jp, js, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=BLOCK_TOL, rtol=BLOCK_TOL)
    assert_tree_close(state, _np(j_state), BLOCK_TOL)
    for step in range(3):
        xt = rng.normal(size=(2, 1, 128)).astype(np.float32)
        out, state = t_rglru.rglru_decode(tp, ts, _t(xt), state)
        j_out, j_state = j_rglru.rglru_decode(jp, js, jnp.asarray(xt), j_state)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=BLOCK_TOL, rtol=BLOCK_TOL,
                                   err_msg=f"step {step}")
        assert_tree_close(state, _np(j_state), BLOCK_TOL)


# ---------------------------------------------------------------------------
# the slice as a whole: prefill + decode + serve against the JAX package
# ---------------------------------------------------------------------------

def test_recurrentgemma_prefill_decode_serve_match_jax():
    tc, jc = _rgemma_cfg(window=32)
    assert TT._split_layers(tc) == (1, ["rglru"])
    whole_model(tc, jc, prompt_len=80, new_tokens=8, seed=0)


def test_gemma2_prefill_decode_serve_match_jax():
    tc, jc = t_configs.smoke_config("gemma2-2b"), j_smoke_config("gemma2-2b")
    assert tc.attn_softcap == 50.0 and tc.final_softcap == 30.0
    assert tc.block_pattern == ("local", "attn")
    whole_model(tc, jc, prompt_len=48, new_tokens=6, seed=1)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_prefill_decode_serve_match_jax(arch):
    tc, jc = t_configs.smoke_config(arch), j_smoke_config(arch)
    full = t_configs.get_config(arch)
    assert (tc.qkv_bias, tc.qk_norm, tc.rope_theta) == (full.qkv_bias, full.qk_norm, full.rope_theta)
    assert list(tc.layer_kinds()) == ["attn", "attn"]
    whole_model(tc, jc, prompt_len=40, new_tokens=5, seed=DENSE.index(arch) + 2)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_attention_at_full_head_layout_matches_jax(arch):
    """One attention block at the arch's own heads, kv heads, head_dim 128,
    QKV bias, qk-norm and rope_theta (the smoke config keeps 4 heads), with
    non-zero biases and norm scales, against the JAX block; and the ring
    decode of the same block for a few steps."""
    cfg = t_configs.get_config(arch)
    kw = dict(d_model=64, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim, qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
              rope_theta=cfg.rope_theta)
    ts, js = t_attn.AttnSpec(**kw), j_attn.AttnSpec(**kw)
    jp = j_attn.init_attention(jax.random.PRNGKey(cfg.num_heads), js)
    jp = {k: (v + 0.1 if k in ("bq", "bk", "bv", "q_norm", "k_norm") else v) for k, v in jp.items()}
    tp = _port(jp)
    x = np.random.default_rng(4).normal(size=(1, 19, 64)).astype(np.float32)
    out, (k, v) = t_attn.attention_fwd(tp, ts, _t(x))
    j_out, (jk, jv) = j_attn.attention_fwd(jp, js, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=BLOCK_TOL, rtol=BLOCK_TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=BLOCK_TOL, rtol=BLOCK_TOL)
    tcache = t_attn.init_cache(ts, 1, 8)
    jcache = j_attn.init_cache(js, 1, 8, jnp.float32)
    for pos in range(3):
        xt = x[:, pos:pos + 1] * 0.5
        o, tcache = t_attn.attention_decode(tp, ts, _t(xt), tcache, pos)
        jo, jcache = j_attn.attention_decode(jp, js, jnp.asarray(xt), jcache,
                                             jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=BLOCK_TOL, rtol=BLOCK_TOL)


def _smoke_batch(cfg, seed, b=2, s=24):
    gen = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen)}


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """tests/test_models_smoke.py's ``test_decode_matches_forward`` on the
    port, from its own seeded init: prefill then per-token decode equal
    the teacher-forced ``forward`` within 2e-3."""
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


@pytest.mark.parametrize("arch", DENSE)
def test_apply_retention_shrinks(arch):
    """tests/test_models_smoke.py's ``test_apply_retention_shrinks`` on the
    port: fewer params at retention 0.5 with heads pruned, GQA well formed,
    and the reconfigured model runs to finite logits."""
    cfg = t_configs.smoke_config(arch)
    sub_cfg = t_apply_retention(cfg, 0.5, prune_heads=True)
    assert t_param_count(sub_cfg) < t_param_count(cfg)
    assert sub_cfg.num_heads % sub_cfg.num_kv_heads == 0
    params = TT.init_params(torch.Generator().manual_seed(2), sub_cfg)
    logits, _ = TT.forward(params, sub_cfg, _smoke_batch(sub_cfg, 2))
    assert logits.shape == (2, 24, sub_cfg.vocab_size) and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", DENSE)
def test_serve_decode_example_runs_each_dense_arch_on_cpu(arch, capsys):
    """``examples/torch_serve_decode.py --device cpu``: one ``[serve]`` line
    for the full smoke config and one for its retention-0.5 replica."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_serve_decode.py"
    spec = importlib.util.spec_from_file_location("torch_serve_decode", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--new-tokens", "3"])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[serve]")]
    assert [l.split(":")[0] for l in lines] == [f"[serve] {arch} gamma=1.0",
                                                f"[serve] {arch} gamma=0.5"]
    full, half = (int(l.split(": ")[1].split(" params")[0].replace(",", "")) for l in lines)
    assert half < full == t_param_count(t_configs.smoke_config(arch))


def test_retention_submodel_serves_and_matches_jax_prefill():
    tc, jc = _rgemma_cfg()
    tc, jc = t_apply_retention(tc, 0.5), j_apply_retention(jc, 0.5)
    assert tc.d_ff == jc.d_ff < 512 and tc.rnn_width == jc.rnn_width < 256
    jp = JT.init_params(jax.random.PRNGKey(5), jc)
    prompts = np.random.default_rng(5).integers(0, tc.vocab_size, size=(2, 40))
    t_logits, _ = TT.prefill(_port(jp), tc, {"tokens": _t(prompts)})
    j_logits, _ = JT.prefill(jp, jc, {"tokens": jnp.asarray(prompts, jnp.int32)})
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_vocab_padding_is_masked():
    tc, _ = _rgemma_cfg()
    tc = tc.replace(vocab_size_real=500)
    tp = TT.init_params(torch.Generator().manual_seed(0), tc)
    logits, _ = TT.prefill(tp, tc, {"tokens": torch.zeros(1, 5, dtype=torch.long)})
    assert float(logits[:, 500:].max()) == float(np.float32(-1e30)) and bool(torch.isfinite(logits[:, :500]).all())


# ---------------------------------------------------------------------------
# refusals and the device rule
# ---------------------------------------------------------------------------

_BASE = ModelConfig(name="t", arch_type="dense", num_layers=2, d_model=64, num_heads=2,
                    num_kv_heads=1, d_ff=128, vocab_size=64, head_dim=64)


@pytest.mark.parametrize("field,value,match", [
    # the four block kinds of slice 16 and the three fields of slice 17: no
    # longer refused, they run
    ("block_pattern", ("moe",), None),
    ("block_pattern", ("attn", "moe_local"), None),
    ("block_pattern", ("mlstm",), None),
    ("block_pattern", ("slstm",), None),
    ("encoder_layers", 2, None),
    ("num_prefix_embeds", 8, None),
    ("pos_embed", "learned", None),
    ("dtype", "float16", "dtype"),
])
def test_out_of_slice_fields_are_refused_by_name(field, value, match):
    cfg = _BASE.replace(**{field: value})
    if match is None:
        # a ported block kind or field inits, prefills and serves on the CPU
        # (an encoder-decoder with 16 zero frames, a prefix model with its
        # zero prefix: the serve CLI's extra inputs)
        cfg = cfg.replace(num_experts=4, experts_per_tok=2, window_size=8, max_position=64)
        TT.validate_config(cfg)
        params = TT.init_params(torch.Generator().manual_seed(0), cfg)
        prompts = torch.randint(0, cfg.vocab_size, (2, 12), generator=torch.Generator().manual_seed(0))
        extra = t_serve.extra_inputs(cfg, 2, "cpu")
        logits, state = TT.prefill(params, cfg, {"tokens": prompts, **extra})
        assert logits.shape == (2, cfg.vocab_size) and bool(torch.isfinite(logits).all())
        assert state["pos"] == 12 + cfg.num_prefix_embeds
        gen = t_serve.serve_batch(cfg, params, prompts, 2, extra, device="cpu")
        assert tuple(gen.shape) == (2, 2)
        return
    for call in (lambda: TT.init_params(torch.Generator(), cfg),
                 lambda: TT.prefill({}, cfg, {"tokens": torch.zeros(1, 2, dtype=torch.long)}),
                 lambda: t_serve.serve_batch(cfg, {"embed": torch.zeros(1)}, torch.zeros(1, 2),
                                             device="cpu")):
        with pytest.raises(ValueError, match=rf"ModelConfig\.{field}: .*{match}") as err:
            call()
        assert "ROADMAP" in str(err.value)


def test_serve_on_cuda_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' legitimately runs")
    tc = t_configs.smoke_config("gemma2-2b")
    tp = TT.init_params(torch.Generator().manual_seed(0), tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.serve_batch(tc, tp, torch.zeros(1, 4, dtype=torch.long), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_serve.main(["--arch", "gemma2-2b", "--smoke"])


def test_serve_main_runs_on_cpu(capsys):
    out = t_serve.main(["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "40", "--new-tokens", "4",
                        "--retention", "0.5"])
    assert tuple(out.shape) == (2, 4)
    assert "[serve] recurrentgemma-9b retention=0.5 on cpu" in capsys.readouterr().out


@pytest.mark.cuda
def test_cuda_serve_matches_cpu_and_launches_both_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc and run only on the card")
    tc, _ = _rgemma_cfg(window=32)
    tp = TT.init_params(torch.Generator().manual_seed(0), tc)
    prompts = torch.randint(0, tc.vocab_size, (2, 80), generator=torch.Generator().manual_seed(0))
    cpu_gen, cpu_logits = t_serve.serve_batch(tc, tp, prompts, 8, device="cpu", return_logits=True)
    fa_mod.reset_launches()
    rg_mod.reset_launches()
    gpu_gen, gpu_logits = t_serve.serve_batch(tc, TT.tree_map(lambda t: t.cuda(), tp), prompts, 8,
                                              device="cuda", return_logits=True)
    assert fa_mod.LAUNCHES["flash_attention"] == 1 and rg_mod.LAUNCHES["rg_lru_scan"] == 3
    torch.testing.assert_close(gpu_logits.cpu(), cpu_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert torch.equal(gpu_gen.cpu(), cpu_gen)


def test_serve_runs_in_ieee_f32_and_restores_flags(monkeypatch):
    tc = t_configs.smoke_config("gemma2-2b")
    tp = TT.init_params(torch.Generator().manual_seed(0), tc)
    seen = []
    real_prefill = TT.prefill

    def spy(*a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_prefill(*a, **k)

    monkeypatch.setattr(TT, "prefill", spy)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        t_serve.serve_batch(tc, tp, torch.zeros(1, 4, dtype=torch.long), 1, device="cpu")
        assert seen == [False]
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
