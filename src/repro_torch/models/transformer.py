"""Model assembly for the LLM serving and training paths (port of ``repro/models/transformer.py``).

Decoder stacks of the reference's six block kinds: ``attn`` / ``local``
(attention + FFN), ``moe`` / ``moe_local`` (attention + mixture of experts,
``moe_local`` windowed), ``rglru`` (RG-LRU + FFN) and ``mlstm`` / ``slstm``
(one xLSTM cell, params ``{"ln", "cell"}``).  With ``cfg.encoder_layers``
(Whisper) an encoder of ``attn`` blocks (``params["enc_blocks"]["s0"]``,
stacked over its layers) runs over ``batch["enc_embeds"]`` plus learned
positions ``enc_pos``, and every attention block of the decoder adds a
cross-attention step (``lnx``, ``xattn``) to its output after its
self-attention.  As in the reference, the encoder's self-attention is
causal (``_run_encoder``; Whisper's own encoder is bidirectional).  With
``cfg.num_prefix_embeds`` (InternVL) ``batch["prefix_embeds"]`` go in front
of the token embeddings; ``forward`` drops their positions and ``prefill``
counts them in the cache.  ``pos_embed="learned"`` adds ``pos_embed`` rows
to the embedded sequence and each decode step.  Full periods
of ``cfg.block_pattern`` are parameter-stacked on a leading group axis
(``params["blocks"]["s{j}"]``), exactly as the JAX package stacks them for
``lax.scan``; here a Python loop indexes one group at a time.  Remainder
layers are the list ``params["rem"]``.  ``constrain`` and ``jax.checkpoint``
have no counterpart: on one device both are no-ops or training-only.

Entry points:
  * ``forward(params, cfg, batch)``               -> (logits, aux), aux the
    sum of the MoE layers' load-balance losses (0 without MoE layers)
  * ``lm_loss(params, cfg, batch)``               -> next-token cross
    entropy + aux, differentiable (``launch/train.py`` trains on it)
  * ``prefill(params, cfg, batch, max_len)``      -> (last logits, state)
  * ``decode_step(params, cfg, state, token)``    -> (logits, state)

The decode state holds ring-buffer KV caches and recurrent states, stacked
over groups like the parameters, and the next position as a Python int; an
encoder-decoder's attention caches are ``{"self": ring, "cross_k",
"cross_v"}``, the cross K/V the raw ``enc_out @ wk`` / ``wv`` of prefill.

``cfg.dtype`` is "float32" or "bfloat16", the JAX dry-run's dtype: every
parameter and state leaf takes the dtype of its JAX counterpart (the
RG-LRU's ``lam`` and recurrent state ``h`` stay float32), activations run
in ``cfg.dtype``, norms, rope, softmax and the recurrence compute in
float32 as in the JAX package, and the logits come out float32.
``decode_step`` updates the caches in place (the JAX version returns new
arrays), so a step writes one ring slot instead of copying the cache.

Dtypes other than float32 and bfloat16 are refused by name
(``validate_config``), as are unknown block kinds, norms and position
embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.sharding.specs import current_mesh

from . import attention as attn_mod
from . import ffn as ffn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import xlstm as xlstm_mod
from .attention import AttnSpec
from .config import ModelConfig
from .ffn import FFNSpec
from .layers import layer_norm, normal_init, rms_norm, softcap
from .moe import MoESpec
from .rglru import RGLRUSpec
from .xlstm import XLSTMSpec

__all__ = [
    "SUPPORTED_KINDS",
    "validate_config",
    "DTYPES",
    "param_dtype",
    "init_params",
    "forward",
    "lm_loss",
    "prefill",
    "init_decode_state",
    "decode_step",
    "tree_map",
]

SUPPORTED_KINDS = ("attn", "local", "moe", "moe_local", "rglru", "mlstm", "slstm")
_ATTN_KINDS = ("attn", "local", "moe", "moe_local")
_MOE_KINDS = ("moe", "moe_local")
_XLSTM_KINDS = ("mlstm", "slstm")
# ModelConfig.dtype -> torch dtype: the JAX package's two model dtypes (the
# FL simulation's float32 and the dry-run's bfloat16)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _refuse(field: str, why: str) -> ValueError:
    return ValueError(
        f"ModelConfig.{field}: {why} — not ported to repro_torch yet "
        "(see ROADMAP.md, queue A)"
    )


def validate_config(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` naming the first field outside this slice."""
    for kind in cfg.block_pattern:
        if kind not in SUPPORTED_KINDS:
            raise ValueError(f"ModelConfig.block_pattern: unknown block kind {kind!r}")
    if cfg.pos_embed not in ("rope", "learned"):
        raise ValueError(f"ModelConfig.pos_embed: unknown {cfg.pos_embed!r}")
    if cfg.dtype not in DTYPES:
        raise _refuse("dtype", f"dtype={cfg.dtype!r} (the port runs {sorted(DTYPES)})")
    if cfg.norm_style not in ("rms", "layernorm"):
        raise ValueError(f"ModelConfig.norm_style: unknown {cfg.norm_style!r}")


# --------------------------------------------------------------------------
# pytrees of tensors
# --------------------------------------------------------------------------

def tree_map(fn, tree):
    """Apply ``fn`` to every tensor leaf of nested dicts / lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _stack(trees: List[Any]):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _copy_into(dst, src) -> None:
    """Write a block's new decode cache into its (stacked) slot in place
    (an attention cache comes back as the same, already updated, views;
    an encoder-decoder's nests its ring under ``"self"``)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        elif v is not dst[k]:
            dst[k].copy_(v)


# --------------------------------------------------------------------------
# specs per block kind
# --------------------------------------------------------------------------

def _attn_spec(cfg: ModelConfig, kind: str, causal: bool = True) -> AttnSpec:
    return AttnSpec(
        d_model=cfg.d_model,
        num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qk_norm=cfg.qk_norm,
        qkv_bias=cfg.qkv_bias,
        logit_softcap=cfg.attn_softcap,
        window=cfg.window_size if kind in ("local", "moe_local") else None,
        causal=causal,
        rope_theta=cfg.rope_theta,
        use_rope=cfg.pos_embed == "rope",
    )


def _cross_spec(cfg: ModelConfig) -> AttnSpec:
    """The decoder's cross-attention: every encoder frame kept."""
    return _attn_spec(cfg, "attn", causal=False)


def _ffn_spec(cfg: ModelConfig) -> FFNSpec:
    return FFNSpec(cfg.d_model, cfg.d_ff, gated=cfg.gated_ffn, activation=cfg.activation)


def _moe_spec(cfg: ModelConfig) -> MoESpec:
    return MoESpec(
        d_model=cfg.d_model,
        num_experts=cfg.num_experts,
        num_experts_per_tok=cfg.experts_per_tok,
        d_ff=cfg.d_ff,
        capacity_factor=cfg.moe_capacity_factor,
        shared_expert=cfg.shared_expert,
    )


def _rglru_spec(cfg: ModelConfig) -> RGLRUSpec:
    return RGLRUSpec(cfg.d_model, cfg.rnn_width or cfg.d_model, cfg.rnn_heads)


def _xlstm_spec(cfg: ModelConfig) -> XLSTMSpec:
    return XLSTMSpec(cfg.d_model, cfg.num_heads, cfg.xlstm_proj_factor, t_block=cfg.attn_q_block)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def param_dtype(cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of ``cfg.dtype``."""
    return DTYPES[cfg.dtype]


def _init_norm(cfg: ModelConfig, lead, device):
    shape, dt = (*lead, cfg.d_model), param_dtype(cfg)
    if cfg.norm_style == "layernorm":
        return {"scale": torch.ones(shape, dtype=dt, device=device),
                "bias": torch.zeros(shape, dtype=dt, device=device)}
    return {"scale": torch.zeros(shape, dtype=dt, device=device)}


def _apply_norm(cfg: ModelConfig, p, x):
    if cfg.norm_style == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, lead=(), cross: bool = False):
    """One block's params; ``cross`` adds an attention block's cross step
    (``lnx``, ``xattn``), as the reference gives every decoder block of an
    encoder-decoder."""
    dev, dt = gen.device, param_dtype(cfg)
    if kind in _ATTN_KINDS:
        p = {
            "ln1": _init_norm(cfg, lead, dev),
            "attn": attn_mod.init_attention(gen, _attn_spec(cfg, kind), lead, dt),
            "ln2": _init_norm(cfg, lead, dev),
        }
        if kind in _MOE_KINDS:
            p["moe"] = moe_mod.init_moe(gen, _moe_spec(cfg), lead, dt)
        else:
            p["ffn"] = ffn_mod.init_ffn(gen, _ffn_spec(cfg), lead, dt)
        if cross:
            p["lnx"] = _init_norm(cfg, lead, dev)
            p["xattn"] = attn_mod.init_attention(gen, _cross_spec(cfg), lead, dt)
        return p
    if kind == "rglru":
        return {
            "ln1": _init_norm(cfg, lead, dev),
            "rglru": rglru_mod.init_rglru(gen, _rglru_spec(cfg), lead, dt),
            "ln2": _init_norm(cfg, lead, dev),
            "ffn": ffn_mod.init_ffn(gen, _ffn_spec(cfg), lead, dt),
        }
    if kind in _XLSTM_KINDS:
        init = xlstm_mod.init_mlstm if kind == "mlstm" else xlstm_mod.init_slstm
        return {"ln": _init_norm(cfg, lead, dev), "cell": init(gen, _xlstm_spec(cfg), lead, dt)}
    raise ValueError(f"unknown block kind {kind}")


def _split_layers(cfg: ModelConfig) -> Tuple[int, List[str]]:
    """(num_full_groups, remainder_kinds)."""
    period = len(cfg.block_pattern)
    if not cfg.scan_layers:
        return 0, list(cfg.layer_kinds())
    g = cfg.num_layers // period
    return g, list(cfg.layer_kinds()[g * period:])


@torch.no_grad()
def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Random parameters on ``gen``'s device: the JAX package's tree, shapes
    and dtypes (the values differ: another generator)."""
    validate_config(cfg)
    dt = param_dtype(cfg)
    params: Dict[str, Any] = {"embed": normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt)}
    if cfg.pos_embed == "learned":
        params["pos_embed"] = normal_init(gen, (cfg.max_position, cfg.d_model), 0.01, dt)
    g, rem = _split_layers(cfg)
    cross = cfg.encoder_layers > 0
    if g > 0:
        params["blocks"] = {
            f"s{j}": _init_block(gen, cfg, kind, lead=(g,), cross=cross)
            for j, kind in enumerate(cfg.block_pattern)
        }
    if rem:
        params["rem"] = [_init_block(gen, cfg, kind, cross=cross) for kind in rem]
    params["final_norm"] = _init_norm(cfg, (), gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (cfg.d_model, cfg.vocab_size), 0.02, dt)
    if cross:
        params["enc_blocks"] = {"s0": _init_block(gen, cfg, "attn", lead=(cfg.encoder_layers,))}
        params["enc_norm"] = _init_norm(cfg, (), gen.device)
        params["enc_pos"] = normal_init(gen, (cfg.max_position, cfg.d_model), 0.01, dt)
    return params


# --------------------------------------------------------------------------
# full-sequence forward (prefill)
# --------------------------------------------------------------------------

def _mix_fwd(cfg: ModelConfig, kind: str, p, x):
    """The FFN or MoE half of an attention or RG-LRU block: (x, aux)."""
    h_in = _apply_norm(cfg, p["ln2"], x)
    if kind in _MOE_KINDS:
        h, aux = moe_mod.moe_fwd(p["moe"], _moe_spec(cfg), h_in)
        return x + h, aux
    return x + ffn_mod.ffn_fwd(p["ffn"], _ffn_spec(cfg), h_in), None


def _block_fwd(cfg: ModelConfig, kind: str, p, x, enc_out, collect_cache: bool,
               cache_len: int = 0):
    """Returns (x, aux_loss or None, cache_or_None); ``enc_out`` is the
    encoder's output that a block's cross step reads (None without)."""
    cache = aux = None
    if kind in _ATTN_KINDS:
        h, (k, v) = attn_mod.attention_fwd(p["attn"], _attn_spec(cfg, kind),
                                           _apply_norm(cfg, p["ln1"], x))
        x = x + h
        if "xattn" in p:
            h, _ = attn_mod.attention_fwd(p["xattn"], _cross_spec(cfg),
                                          _apply_norm(cfg, p["lnx"], x), xkv=enc_out)
            x = x + h
        x, aux = _mix_fwd(cfg, kind, p, x)
        if collect_cache:
            cache = _ringify(cfg, kind, k, v, cache_len, p, enc_out)
    elif kind == "rglru":
        h, cache = rglru_mod.rglru_fwd(p["rglru"], _rglru_spec(cfg), _apply_norm(cfg, p["ln1"], x))
        x, _ = _mix_fwd(cfg, kind, p, x + h)
    elif kind in _XLSTM_KINDS:
        fwd = xlstm_mod.mlstm_fwd if kind == "mlstm" else xlstm_mod.slstm_fwd
        h, cache = fwd(p["cell"], _xlstm_spec(cfg), _apply_norm(cfg, p["ln"], x))
        x = x + h
    else:
        raise ValueError(kind)
    return x, aux, (cache if collect_cache else None)


def _ringify(cfg: ModelConfig, kind: str, k, v, cache_len: int, p, enc_out):
    """Prefill K/V as the ring-buffer decode cache of capacity ``cache_len``
    (windowed layers clamp it to the window, so the ring rotates).  A block
    with a cross step also keeps the encoder's K/V for decode, as the
    reference computes them: ``enc_out @ wk`` / ``wv``, without the bias or
    ``k_norm`` that its prefill applies."""
    spec = _attn_spec(cfg, kind)
    b, s = k.shape[0], k.shape[1]
    L = min(cache_len, spec.window) if spec.window is not None else cache_len
    dev = k.device
    if s >= L:
        # keep the last L entries; their slots are pos % L (ring semantics)
        tail_pos = torch.arange(s - L, s, dtype=torch.int32, device=dev)
        order = torch.argsort(torch.remainder(tail_pos, L))
        kk = k[:, s - L:].index_select(1, order)
        vv = v[:, s - L:].index_select(1, order)
        pos = tail_pos[order][None].expand(b, L).contiguous()
    else:
        pad = L - s
        kk = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vv = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        pos = torch.cat([torch.arange(s, dtype=torch.int32, device=dev),
                         torch.full((pad,), -1, dtype=torch.int32, device=dev)])
        pos = pos[None].expand(b, L).contiguous()
    cache = {"k": kk, "v": vv, "pos": pos}
    if "xattn" in p:
        cache = {"self": cache, "cross_k": attn_mod._proj(enc_out, p["xattn"]["wk"]),
                 "cross_v": attn_mod._proj(enc_out, p["xattn"]["wv"])}
    return cache


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)
    return x


def _learned(table: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Rows ``start .. start + n - 1`` of a learned position table, ``[1, n, d]``."""
    if start + n > table.shape[0]:
        raise ValueError(f"positions {start}..{start + n - 1} pass the {table.shape[0]} rows "
                         "of the learned position table (ModelConfig.max_position)")
    return table[start:start + n][None]


def _prefix_len(cfg: ModelConfig, batch) -> int:
    """The vision prefix's length in ``batch`` (0 without one)."""
    if cfg.num_prefix_embeds and "prefix_embeds" in batch:
        return batch["prefix_embeds"].shape[1]
    return 0


def _embed_inputs(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Token embeddings, after the vision prefix where the batch has one,
    plus learned positions over the whole sequence (the reference's order)."""
    x = _embed_tokens(params, cfg, batch["tokens"])
    if _prefix_len(cfg, batch):
        x = torch.cat([batch["prefix_embeds"].to(x.dtype), x], dim=1)
    if cfg.pos_embed == "learned":
        x = x + _learned(params["pos_embed"], 0, x.shape[1])
    return x


def _run_encoder(params, cfg: ModelConfig, enc_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder over ``enc_embeds [b, t, d]``: learned positions, then its
    ``attn`` blocks, then ``enc_norm``.  Its self-attention is causal, as the
    reference's ``_run_encoder`` builds it (``_attn_spec``'s default)."""
    x = enc_embeds.to(param_dtype(cfg))
    x = x + _learned(params["enc_pos"], 0, x.shape[1])
    for li in range(cfg.encoder_layers):
        x, _, _ = _block_fwd(cfg, "attn", _group(params["enc_blocks"], li)["s0"], x, None, False)
    return _apply_norm(cfg, params["enc_norm"], x)


def _encoder_out(params, cfg: ModelConfig, batch):
    """The encoder's output for ``batch`` (None without an encoder)."""
    if not cfg.encoder_layers:
        return None
    if "enc_embeds" not in batch:
        raise ValueError(f"{cfg.name}: an encoder-decoder's batch needs 'enc_embeds' "
                         "[b, frames, d_model]")
    return _run_encoder(params, cfg, batch["enc_embeds"])


def _group(tree, gi: int):
    """Group ``gi`` of a stacked tree (views)."""
    return tree_map(lambda t: t[gi], tree)


def _stack_fwd(params, cfg: ModelConfig, x, enc_out, collect_cache: bool, cache_len: int = 0):
    """Run all layers; returns (x, total_aux, caches dict), the aux losses
    summed in layer order from a float32 zero as the JAX scan carries them."""
    g, rem = _split_layers(cfg)
    caches: Dict[str, Any] = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    if g > 0:
        group_caches = []
        for gi in range(g):
            gp = _group(params["blocks"], gi)
            gc = {}
            for j, kind in enumerate(cfg.block_pattern):
                x, aux, gc[f"s{j}"] = _block_fwd(cfg, kind, gp[f"s{j}"], x, enc_out,
                                                 collect_cache, cache_len)
                if aux is not None:
                    aux_total = aux_total + aux
            group_caches.append(gc)
        if collect_cache:
            caches["blocks"] = _stack(group_caches)
    for i, kind in enumerate(rem):
        x, aux, cache = _block_fwd(cfg, kind, params["rem"][i], x, enc_out, collect_cache,
                                   cache_len)
        if aux is not None:
            aux_total = aux_total + aux
        if collect_cache:
            caches.setdefault("rem", []).append(cache)
    return x, aux_total, caches


def _logits(params, cfg: ModelConfig, x):
    """The head's product in the model dtype, then float32 and the softcap
    (JAX ``_logits``)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = softcap((x @ head).float(), cfg.final_softcap)
    if cfg.vocab_size_real is not None and cfg.vocab_size_real < cfg.vocab_size:
        # vocab was padded up; mask the padding
        mask = torch.arange(cfg.vocab_size, device=logits.device) >= cfg.vocab_size_real
        logits = logits.masked_fill(mask, -1e30)
    return logits


def forward(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward (the training forward). Returns (logits [b,
    s_text, V], aux_loss), the MoE layers' load-balance losses summed (0
    without MoE layers); the vision prefix's positions are dropped.  Autograd
    records it where the params require grad (``lm_loss``); nothing on it
    writes in place into a tensor that autograd keeps."""
    validate_config(cfg)
    enc_out = _encoder_out(params, cfg, batch)
    x = _embed_inputs(params, cfg, batch)
    x, aux, _ = _stack_fwd(params, cfg, x, enc_out, collect_cache=False)
    x = _apply_norm(cfg, params["final_norm"], x[:, _prefix_len(cfg, batch):])
    return _logits(params, cfg, x), aux


def lm_loss(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Next-token cross entropy (+ MoE aux), labels = tokens shifted left
    (JAX ``lm_loss``): ``log_softmax`` of the float32 logits, each label's
    log-probability by the reference's one-hot contraction, averaged over
    the positions that ``batch["loss_mask"]`` keeps (all without one)."""
    mesh = current_mesh()
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        raise NotImplementedError("lm_loss under a model mesh: training on the expert-parallel "
                                  "path is ROADMAP.md item A6")
    logits, aux = forward(params, cfg, batch)
    logits = logits[:, :-1]
    labels = batch["tokens"][:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    # the one-hot built in logp's dtype (F.one_hot would build it in int64)
    onehot = torch.zeros_like(logp).scatter_(-1, labels[..., None].long(), 1.0)
    ll = torch.einsum("bsv,bsv->bs", logp, onehot)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].to(ll.dtype)
        ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        ce = -ll.mean()
    return ce + aux


# --------------------------------------------------------------------------
# inference: prefill + single-token decode
# --------------------------------------------------------------------------

@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch, max_len: int | None = None):
    """Returns (last-position logits [b, V], decode state).

    ``max_len``: total KV-cache capacity (prefill length, the vision prefix
    included, + decode headroom); defaults to 2x that length.  A capacity
    under the prefill length keeps only its last ``max_len`` positions (the
    reference's ring), which turns full attention into a window.
    """
    validate_config(cfg)
    enc_out = _encoder_out(params, cfg, batch)
    x = _embed_inputs(params, cfg, batch)
    s_total = x.shape[1]
    if max_len is None:
        max_len = 2 * s_total
    x, _, caches = _stack_fwd(params, cfg, x, enc_out, collect_cache=True, cache_len=max_len)
    x = _apply_norm(cfg, params["final_norm"], x[:, -1:])
    logits = _logits(params, cfg, x)[:, 0]
    return logits, {"caches": caches, "pos": s_total}


def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int, enc_len: int,
                      device):
    dt = param_dtype(cfg)
    if kind in _ATTN_KINDS:
        spec = _attn_spec(cfg, kind)
        c = attn_mod.init_cache(spec, batch, cache_len, dt, device)
        if cfg.encoder_layers:
            shape = (batch, enc_len, spec.num_kv_heads, spec.head_dim)
            c = {"self": c, "cross_k": torch.zeros(shape, dtype=dt, device=device),
                 "cross_v": torch.zeros(shape, dtype=dt, device=device)}
        return c
    if kind == "rglru":
        return rglru_mod.init_rglru_state(_rglru_spec(cfg), batch, dt, device)
    if kind == "mlstm":
        return xlstm_mod.init_mlstm_state(_xlstm_spec(cfg), batch, device)
    if kind == "slstm":
        return xlstm_mod.init_slstm_state(_xlstm_spec(cfg), batch, device)
    raise ValueError(kind)


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int, enc_len: int = 0, *,
                      device="cpu"):
    """An empty decode state; ``enc_len`` is an encoder-decoder's frame count
    (the cross K/V's length)."""
    validate_config(cfg)
    g, rem = _split_layers(cfg)
    caches: Dict[str, Any] = {}
    if g > 0:
        caches["blocks"] = {
            f"s{j}": tree_map(lambda t: t[None].repeat(g, *([1] * t.dim())),
                              _init_block_cache(cfg, kind, batch, cache_len, enc_len, device))
            for j, kind in enumerate(cfg.block_pattern)
        }
    if rem:
        caches["rem"] = [_init_block_cache(cfg, kind, batch, cache_len, enc_len, device)
                         for kind in rem]
    return {"caches": caches, "pos": 0}


def _block_decode(cfg: ModelConfig, kind: str, p, x, cache, position: int):
    if kind in _XLSTM_KINDS:
        dec = xlstm_mod.mlstm_decode if kind == "mlstm" else xlstm_mod.slstm_decode
        h, cache = dec(p["cell"], _xlstm_spec(cfg), _apply_norm(cfg, p["ln"], x), cache)
        return x + h, cache
    if kind in _ATTN_KINDS:
        # the ring is written in place, so an encoder-decoder's cache dict
        # stays the one passed in
        cross = "cross_k" in cache
        h, _ = attn_mod.attention_decode(p["attn"], _attn_spec(cfg, kind),
                                         _apply_norm(cfg, p["ln1"], x),
                                         cache["self"] if cross else cache, position)
        x = x + h
        if cross:
            x = x + attn_mod.cross_attention_decode(p["xattn"], _cross_spec(cfg),
                                                    _apply_norm(cfg, p["lnx"], x),
                                                    cache["cross_k"], cache["cross_v"])
    elif kind == "rglru":
        h, cache = rglru_mod.rglru_decode(
            p["rglru"], _rglru_spec(cfg), _apply_norm(cfg, p["ln1"], x), cache
        )
        x = x + h
    else:
        raise ValueError(kind)
    x, _ = _mix_fwd(cfg, kind, p, x)
    return x, cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, state, token: torch.Tensor):
    """One decode step. token: [b] int. Returns (logits [b, V], state), the
    state's caches updated in place."""
    position = int(state["pos"])
    x = _embed_tokens(params, cfg, token[:, None])
    if cfg.pos_embed == "learned":
        x = x + _learned(params["pos_embed"], position, 1)
    g, rem = _split_layers(cfg)
    caches = state["caches"]
    for gi in range(g):
        gp = _group(params["blocks"], gi)
        gc = _group(caches["blocks"], gi)
        for j, kind in enumerate(cfg.block_pattern):
            x, new = _block_decode(cfg, kind, gp[f"s{j}"], x, gc[f"s{j}"], position)
            _copy_into(gc[f"s{j}"], new)
    for i, kind in enumerate(rem):
        x, caches["rem"][i] = _block_decode(cfg, kind, params["rem"][i], x,
                                            caches["rem"][i], position)
    x = _apply_norm(cfg, params["final_norm"], x)
    logits = _logits(params, cfg, x)[:, 0]
    return logits, {"caches": caches, "pos": position + 1}
