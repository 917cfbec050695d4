"""Llama-4-Maverick-400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family].

48 layers with interleaved dense/MoE FFN (24 (attn, moe) periods, matching
Maverick's every-other-layer MoE), d_model=5120, 40H (GQA kv=8, head_dim 128),
MoE 128 experts top-1 with per-expert d_ff=8192 plus a shared expert,
vocab=202048 — ~400B total, ~17B active.
"""
from repro_torch.models.config import ModelConfig
from .base import register

CFG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    block_pattern=("attn", "moe"),
    num_experts=128,
    experts_per_tok=1,
    shared_expert=True,
    rope_theta=500_000.0,
    tie_embeddings=False,
))
