"""The port's mixture of experts (``models/moe.py``, kinds ``moe`` and
``moe_local``) and the MoE archs against the JAX package, on the CPU.

Every comparison starts from the JAX package's own init, handed to the port
leaf by leaf through numpy, and from the same numpy inputs.  Bars:
``moe_fwd`` output at 1e-5 and its aux loss at 1e-6 with identical top-k
choices (bf16 output at 2e-2); whole-model logits at 1e-4, greedy tokens
exactly and the forward's aux at 1e-6; the port's decode against its own
forward at 2e-3 (the bar of tests/test_models_smoke.py, at the smoke
configs' drop-free capacity).  The drop case runs at capacity factor 1.0
with the router biased so that one expert overflows: the port drops the
same assignments as JAX, which a float64 recompute of the kept set (each
expert keeps its first C assignments in token order) confirms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import moe as j_moe
from repro_torch import configs as t_configs
from repro_torch.convert import tree_from_numpy, tree_to_numpy
from repro_torch.launch import serve as t_serve
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as TT
from repro_torch.models.config import apply_retention as t_apply_retention
from repro_torch.models.config import param_count as t_param_count
from torch_llm_parity import whole_model

MOE_TOL = 1e-5
AUX_TOL = 1e-6
BF16_TOL = 2e-2
DECODE_TOL = 2e-3
ARCHS = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return tree_from_numpy(_np(tree))


def _spec_pair(**kw):
    return t_moe.MoESpec(**kw), j_moe.MoESpec(**kw)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def _routing(jp, x, k):
    """Both packages' top-k choices on their own router probabilities, as
    sets per token, and the JAX probabilities."""
    xf = x.reshape(-1, x.shape[-1])
    j_probs = jax.nn.softmax(jnp.asarray(xf, jnp.float32) @ jp["w_router"], axis=-1)
    t_probs = torch.softmax(torch.from_numpy(xf.copy()) @ torch.from_numpy(np.array(jp["w_router"])),
                            dim=-1)
    j_choice = np.sort(np.asarray(jax.lax.top_k(j_probs, k)[1]), axis=-1)
    t_choice = np.sort(torch.topk(t_probs, k, dim=-1)[1].numpy(), axis=-1)
    return j_choice, t_choice, np.asarray(j_probs, np.float64)


# (name, spec kwargs, router column bias, dtype)
CASES = [
    ("top2_of_4_drop_free", dict(d_model=64, num_experts=4, num_experts_per_tok=2, d_ff=96,
                                 capacity_factor=4.0), 0.0, "float32"),
    ("drops_at_capacity_1", dict(d_model=64, num_experts=4, num_experts_per_tok=2, d_ff=96,
                                 capacity_factor=1.0), 0.05, "float32"),
    ("shared_expert_top1", dict(d_model=64, num_experts=4, num_experts_per_tok=1, d_ff=96,
                                capacity_factor=4.0, shared_expert=True), 0.0, "float32"),
    ("bf16_top2_of_4", dict(d_model=64, num_experts=4, num_experts_per_tok=2, d_ff=96,
                            capacity_factor=1.0, shared_expert=True), 0.05, "bfloat16"),
]


@pytest.mark.parametrize("name,kw,bias,dtype", CASES, ids=[c[0] for c in CASES])
def test_moe_fwd_matches_jax(name, kw, bias, dtype):
    ts, js = _spec_pair(**kw)
    jdt = jnp.dtype(dtype)
    jp = j_moe.init_moe(jax.random.PRNGKey(len(name)), js, jdt)
    # inputs shifted by +0.5 along every feature and expert 0's router column
    # raised by ``bias``: expert 0's logit gains ~bias * d_model / 2, so most
    # tokens pick it and it overflows its capacity
    jp["w_router"] = jp["w_router"].at[:, 0].add(bias)
    b, s = 2, 40
    x = np.random.default_rng(len(name)).normal(size=(b, s, kw["d_model"])).astype(np.float32)
    x += 0.5 if bias else 0.0
    jx = jnp.asarray(x).astype(jdt)
    x = np.asarray(jx.astype(jnp.float32))                    # the same values on both sides
    tx = torch.from_numpy(x.copy()).to(getattr(torch, dtype))
    j_out, j_aux = jax.jit(lambda p, v: j_moe.moe_fwd(p, js, v))(jp, jx)
    t_out, t_aux = t_moe.moe_fwd(_port(jp), ts, tx)
    assert t_out.dtype == tx.dtype and t_aux.dtype == torch.float32
    k = kw["num_experts_per_tok"]
    j_choice, t_choice, probs = _routing(jp, x, k)
    np.testing.assert_array_equal(t_choice, j_choice)
    tol = BF16_TOL if dtype == "bfloat16" else MOE_TOL
    np.testing.assert_allclose(_f32(t_out), _f32(j_out), atol=tol, rtol=tol)
    np.testing.assert_allclose(float(t_aux), float(j_aux), atol=AUX_TOL, rtol=AUX_TOL)
    C = t_moe.capacity(ts, b * s)
    counts = np.bincount(j_choice.reshape(-1), minlength=kw["num_experts"])
    if bias:
        assert counts[0] > C, (counts, C)                   # expert 0 drops assignments
    else:
        assert counts.max() <= C
    if dtype == "float32":
        # the kept set, recomputed in float64: expert e keeps its first C
        # assignments in token order, the rest add nothing
        P = {n: np.asarray(v, np.float64) for n, v in jp.items()}
        xf = x.reshape(b * s, -1).astype(np.float64)
        silu = lambda a: a / (1.0 + np.exp(-a))
        gates = np.take_along_axis(probs, j_choice, -1)
        gates = gates / gates.sum(-1, keepdims=True)
        seen = np.zeros(kw["num_experts"], int)
        ref = np.zeros_like(xf)
        for t in range(b * s):
            for e, g in zip(j_choice[t], gates[t]):
                if seen[e] < C:
                    h = silu(xf[t] @ P["w_gate"][e]) * (xf[t] @ P["w_up"][e])
                    ref[t] += g * (h @ P["w_down"][e])
                seen[e] += 1
        if kw.get("shared_expert"):
            ref += (silu(xf @ P["ws_gate"]) * (xf @ P["ws_up"])) @ P["ws_down"]
        np.testing.assert_allclose(t_out.numpy().reshape(b * s, -1), ref, atol=MOE_TOL, rtol=MOE_TOL)


def test_moe_is_deterministic_and_chunking_the_experts_changes_no_bit(monkeypatch):
    """Two runs agree bit for bit (the combine takes no atomics), and so do
    the expert products run one expert a chunk (``EXPERT_CHUNK_BYTES``)."""
    ts, _ = _spec_pair(d_model=32, num_experts=8, num_experts_per_tok=3, d_ff=48,
                       capacity_factor=1.0)
    params = t_moe.init_moe(torch.Generator().manual_seed(0), ts)
    x = torch.randn(3, 50, 32, generator=torch.Generator().manual_seed(1))
    a, aux_a = t_moe.moe_fwd(params, ts, x)
    b, aux_b = t_moe.moe_fwd(params, ts, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    monkeypatch.setattr(t_moe, "EXPERT_CHUNK_BYTES", 1)
    c, aux_c = t_moe.moe_fwd(params, ts, x)
    assert torch.equal(a, c) and torch.equal(aux_a, aux_c)


def test_init_moe_tree_and_router_dtype():
    ts, js = _spec_pair(d_model=32, num_experts=4, num_experts_per_tok=1, d_ff=48,
                        shared_expert=True)
    tp = t_moe.init_moe(torch.Generator().manual_seed(0), ts, lead=(3,), dtype=torch.bfloat16)
    jp = jax.eval_shape(lambda k: j_moe.init_moe(k, js, jnp.bfloat16), jax.random.PRNGKey(0))
    for name, leaf in jp.items():
        assert tuple(tp[name].shape) == (3, *leaf.shape), name
        assert str(tp[name].dtype).replace("torch.", "") == str(leaf.dtype), name
    assert tp["w_router"].dtype == torch.float32
    # each expert drawn at fan-in D (w_down: F), truncated at 2 sigma
    assert float(tp["w_gate"].float().abs().max()) <= 2.0 / np.sqrt(32) * (1 + 1e-2)
    assert float(tp["w_down"].float().abs().max()) <= 2.0 / np.sqrt(48) * (1 + 1e-2)


# ---------------------------------------------------------------------------
# whole models: prefill, decode, serve and the aux loss against JAX
# ---------------------------------------------------------------------------

def _moe_local_cfgs():
    """Smoke granite as (moe_local, moe) with a 16-token window under the
    prompt length, so that the windowed MoE kind's ring rotates."""
    kw = dict(block_pattern=("moe_local", "moe"), window_size=16)
    return (t_configs.smoke_config("granite-moe-1b-a400m").replace(**kw),
            j_smoke_config("granite-moe-1b-a400m").replace(**kw))


@pytest.mark.parametrize("which", ARCHS + ["granite-moe_local"])
def test_moe_arch_prefill_decode_serve_and_aux_match_jax(which):
    if which == "granite-moe_local":
        tc, jc = _moe_local_cfgs()
    else:
        tc, jc = t_configs.smoke_config(which), j_smoke_config(which)
    assert tc.moe_capacity_factor >= tc.num_experts           # drop-free smoke capacity
    assert whole_model(tc, jc, prompt_len=40, new_tokens=5, seed=11 + len(which)) > 0


def test_moe_trees_round_trip_through_convert():
    tc = t_configs.smoke_config("llama4-maverick-400b-a17b")
    tp = TT.init_params(torch.Generator().manual_seed(0), tc)
    w = tp["blocks"]["s1"]["moe"]["w_gate"]
    assert tuple(w.shape) == (1, tc.num_experts, tc.d_model, tc.d_ff)
    back = tree_from_numpy(tree_to_numpy(tp))
    assert torch.equal(back["blocks"]["s1"]["moe"]["w_gate"], w)
    assert torch.equal(back["blocks"]["s1"]["moe"]["ws_down"], tp["blocks"]["s1"]["moe"]["ws_down"])


# ---------------------------------------------------------------------------
# twins of tests/test_models_smoke.py on the port, from its own init
# ---------------------------------------------------------------------------

def _smoke_batch(cfg, seed, b=2, s=24):
    gen = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen)}


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_retention_shrinks(arch):
    cfg = t_configs.smoke_config(arch)
    sub_cfg = t_apply_retention(cfg, 0.5, prune_heads=True)
    assert t_param_count(sub_cfg) < t_param_count(cfg)
    assert sub_cfg.num_heads % sub_cfg.num_kv_heads == 0
    assert sub_cfg.experts_per_tok <= sub_cfg.num_experts < cfg.num_experts
    params = TT.init_params(torch.Generator().manual_seed(2), sub_cfg)
    logits, aux = TT.forward(params, sub_cfg, _smoke_batch(sub_cfg, 2))
    assert logits.shape == (2, 24, sub_cfg.vocab_size) and bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(aux)) and float(aux) > 0


def test_serve_main_runs_a_moe_arch_on_cpu(capsys):
    out = t_serve.main(["--arch", "granite-moe-1b-a400m", "--smoke", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "24", "--new-tokens", "3"])
    assert tuple(out.shape) == (2, 3)
    assert "[serve] granite-moe-1b-a400m retention=1.0 on cpu" in capsys.readouterr().out
