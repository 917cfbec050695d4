"""The port's LLM serving path as a whole against the JAX package, on the
CPU: prefill, decode and ``serve_batch`` of smoke recurrentgemma, gemma2 and
the dense archs (``tests/torch_llm_parity.whole_model``), the dense archs at
their full head layout, decode against the port's own forward, retention
sub-models and the padded vocabulary.  The layers, blocks, configs and
refusals are ``tests/test_torch_transformer.py``'s; this file holds the
whole-model runs, at its bars: logits at 1e-4, greedy tokens exactly, decode
against the port's forward at 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import attention as j_attn
from repro.models import transformer as JT
from repro.models.config import apply_retention as j_apply_retention
from repro_torch import configs as t_configs
from repro_torch.convert import tree_from_numpy
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as TT
from repro_torch.models.config import apply_retention as t_apply_retention
from repro_torch.models.config import param_count as t_param_count
from torch_llm_parity import whole_model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The models here are tiny: one intra-op thread beats a pool of them,
    which only contends with the suite's other workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4
DECODE_TOL = 2e-3
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
    j_logits, _ = jax.jit(lambda p, t: JT.prefill(p, jc, {"tokens": t}))(
        jp, jnp.asarray(prompts, jnp.int32))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_vocab_padding_is_masked():
    tc, _ = _rgemma_cfg()
    tc = tc.replace(vocab_size_real=500)
    tp = TT.init_params(torch.Generator().manual_seed(0), tc)
    logits, _ = TT.prefill(tp, tc, {"tokens": torch.zeros(1, 5, dtype=torch.long)})
    assert float(logits[:, 500:].max()) == float(np.float32(-1e30)) and bool(torch.isfinite(logits[:, :500]).all())
