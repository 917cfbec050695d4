"""Config registry, input shapes and the smoke reduction (port of
``repro/configs/base.py``).

The port registers all ten of the reference's architectures: the hybrid
``recurrentgemma-9b``, ``gemma2-2b``, the dense attention archs
``internlm2-1.8b``, ``qwen1.5-32b``, ``qwen3-32b``, the MoE archs
``granite-moe-1b-a400m`` and ``llama4-maverick-400b-a17b``, ``xlstm-1.3b``,
the encoder-decoder ``whisper-small`` and the vision-prefix
``internvl2-76b``.  ``get_config`` of any other name raises a
``ValueError`` that names it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig

__all__ = ["register", "get_config", "smoke_config", "list_archs", "SHAPES", "InputShape"]

_REGISTRY: Dict[str, ModelConfig] = {}

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise ValueError(f"get_config: unknown arch {name!r}; archs: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    cfg = get_config(name)
    pattern = cfg.block_pattern
    if len(pattern) > 2:
        # keep family coverage: one recurrent + one attention-ish kind
        kinds = list(dict.fromkeys(pattern))  # unique, order-preserving
        pattern = tuple(kinds[:2]) if len(kinds) >= 2 else (pattern[0],) * 2
    d_model = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    heads = (heads // kv) * kv or kv
    kw = dict(
        num_layers=2,
        block_pattern=pattern,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=64,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        window_size=min(cfg.window_size, 32) if cfg.window_size else None,
        max_position=4096,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_tok=min(cfg.experts_per_tok, 2) if cfg.experts_per_tok else 0,
        # drop-free capacity: incremental decode == teacher-forced forward
        moe_capacity_factor=float(max(cfg.num_experts, 1)),
        rnn_width=256 if cfg.rnn_width else None,
        rnn_heads=4 if cfg.rnn_width else cfg.rnn_heads,
        encoder_layers=2 if cfg.encoder_layers else 0,
        num_prefix_embeds=8 if cfg.num_prefix_embeds else 0,
        dtype="float32",    # as the JAX smoke reduction; bf16 is cfg.replace(dtype="bfloat16")
        attn_q_block=None,
        scan_layers=cfg.scan_layers,
    )
    return cfg.replace(**kw)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        gemma2_2b,
        granite_moe_1b_a400m,
        internlm2_1_8b,
        internvl2_76b,
        llama4_maverick_400b_a17b,
        qwen1_5_32b,
        qwen3_32b,
        recurrentgemma_9b,
        whisper_small,
        xlstm_1_3b,
    )
