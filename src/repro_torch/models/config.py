"""Model configuration (port of ``repro/models/config.py``; pure Python).

The port keeps its own copy so that it never imports the JAX package.
`block_pattern` tiles over `num_layers` (remainder layers allowed); full
pattern periods are stacked on a leading group axis and the remainder
layers are kept as a list.

AdaptCL integration: `retention` < 1 means this config is a *reconfigured
sub-model* of the base (see `apply_retention`): physically smaller arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["ModelConfig", "apply_retention", "param_count", "flops_per_token"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None      # None => d_model // num_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    window_size: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    gated_ffn: bool = True
    activation: str = "silu"
    norm_style: str = "rms"             # rms | layernorm
    pos_embed: str = "rope"             # rope | learned
    max_position: int = 32768           # learned-pos table size
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    embed_scale: bool = False           # gemma-style sqrt(d) embedding scale
    # --- MoE ---
    num_experts: int = 0
    experts_per_tok: int = 0
    shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    # --- recurrent ---
    rnn_width: Optional[int] = None     # RG-LRU lru width
    rnn_heads: int = 16                 # RG-LRU gate blocks
    xlstm_proj_factor: float = 2.0
    # --- enc-dec / multimodal ---
    encoder_layers: int = 0
    frontend: Optional[str] = None      # None | "audio" | "vision" (stubs)
    num_prefix_embeds: int = 0          # patch/frame embeddings in the seq
    # --- execution ---
    dtype: str = "float32"
    attn_q_block: Optional[int] = 1024  # q-block size for memory-safe attention
    # shard the residual stream's seq dim over the model axis at layer
    # boundaries (context-parallel activations): divides remat-save memory by
    # the model-axis size at the cost of per-layer seq all-gathers (§Perf)
    seq_shard_activations: bool = False
    scan_layers: bool = True
    remat: bool = True
    # --- AdaptCL ---
    retention: float = 1.0              # gamma of this (sub-)model
    # when vocab_size was padded up for sharding divisibility, the real size
    # (logits above it are masked to -inf in _logits)
    vocab_size_real: Optional[int] = None

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_kinds(self) -> Tuple[str, ...]:
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))


def _snap(x: float, mult: int, lo: int) -> int:
    return max(lo, int(round(x / mult)) * mult)


def apply_retention(cfg: ModelConfig, gamma: float, prune_heads: bool = False) -> ModelConfig:
    """NetworkReconfigure at config level: uniform unit retention gamma.

    Production path (``prune_heads=False``, default): prunes FFN columns /
    experts / recurrent channels and keeps attention heads — head counts are
    tied to the tensor-parallel mesh factorization (e.g. 16 heads on a 16-way
    model axis), and shrinking them would unshard attention (measured: 2x
    *worse* memory at gamma=0.6 — EXPERIMENTS.md §Perf pair 3).  The
    FL-simulation path prunes head groups freely (no TP there); pass
    ``prune_heads=True`` to reproduce that behaviour at config level.

    Dims snap to sharding-friendly multiples; the *achieved* retention is
    param_count(sub)/param_count(base), reported by callers.
    """
    if not (0.0 < gamma <= 1.0):
        raise ValueError(f"gamma {gamma} outside (0, 1]")
    if gamma == 1.0:
        return cfg
    kw = dict(
        d_ff=_snap(cfg.d_ff * gamma, 128, 128) if cfg.d_ff else 0,
        retention=gamma,
    )
    if prune_heads:
        kv = max(1, int(round(cfg.num_kv_heads * gamma)))
        kw["num_kv_heads"] = kv
        kw["num_heads"] = kv * cfg.q_per_kv
    if cfg.num_experts:
        kw["num_experts"] = max(max(1, cfg.experts_per_tok), int(round(cfg.num_experts * gamma)))
    if cfg.rnn_width:
        kw["rnn_width"] = _snap(cfg.rnn_width * gamma, cfg.rnn_heads * 8, cfg.rnn_heads * 8)
    if any(k in ("mlstm", "slstm") for k in cfg.block_pattern):
        # xLSTM width lives in the cell projections (d_ff = 0)
        pf = cfg.xlstm_proj_factor * gamma
        # keep d_inner a multiple of 128*heads for MXU/sharding alignment
        di = _snap(cfg.d_model * pf, 128 * cfg.num_heads // cfg.num_heads, 128)
        kw["xlstm_proj_factor"] = di / cfg.d_model
    return cfg.replace(**kw)


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (embedding + blocks + head)."""
    D, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    if cfg.qkv_bias:
        attn += (H + 2 * KV) * hd
    ffn = (3 if cfg.gated_ffn else 2) * D * cfg.d_ff
    moe = 0
    if cfg.num_experts:
        moe = cfg.num_experts * 3 * D * cfg.d_ff + D * cfg.num_experts
        if cfg.shared_expert:
            moe += 3 * D * cfg.d_ff
        ffn = 0
    total = 0
    for kind in cfg.layer_kinds():
        if kind == "attn" or kind == "local":
            total += attn + ffn + 2 * D
        elif kind == "moe":
            total += attn + moe + 2 * D
        elif kind == "rglru":
            R = cfg.rnn_width or D
            blocks = 2 * (R // cfg.rnn_heads) ** 2 * cfg.rnn_heads
            total += 2 * D * R + 4 * R + blocks + R * D + ffn + 2 * D
        elif kind in ("mlstm", "slstm"):
            DI = int(D * cfg.xlstm_proj_factor)
            if kind == "mlstm":
                total += 2 * D * DI + 3 * DI * DI + 2 * DI + DI * D + D
            else:
                total += D * DI + 4 * DI * DI + DI + DI * D + D
    total += cfg.vocab_size * D  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * D
    if cfg.encoder_layers:
        total += cfg.encoder_layers * (attn + ffn + 2 * D) + cfg.max_position * D
    total += D  # final norm
    return int(total)


def flops_per_token(cfg: ModelConfig, seq_len: int) -> float:
    """MODEL_FLOPS per token: 6*N_active (+ attention quadratic term)."""
    n_active = param_count(cfg)
    if cfg.num_experts:
        dense_experts = cfg.num_experts - cfg.experts_per_tok - (1 if cfg.shared_expert else 0)
        n_active -= len([k for k in cfg.layer_kinds() if k == "moe"]) * max(dense_experts, 0) * 3 * cfg.d_model * cfg.d_ff
    flops = 6.0 * n_active
    # attention score/value FLOPs
    hd = cfg.resolved_head_dim
    for kind in cfg.layer_kinds():
        if kind in ("attn", "moe"):
            ctx = seq_len / 2
        elif kind == "local":
            ctx = min(cfg.window_size or seq_len, seq_len) / 2 + (cfg.window_size or 0) / 2
            ctx = min(ctx, seq_len / 2)
        else:
            continue
        flops += 12.0 * cfg.num_heads * hd * ctx
    return flops
