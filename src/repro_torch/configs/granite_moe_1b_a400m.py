"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base]: MoE.

24 layers, d_model=1024, 16H (GQA kv=8, head_dim 64), 32 experts top-8 with
per-expert d_ff=512, vocab=49155.  `window_size` is populated only when the
long-context sliding-window variant is selected (launch --variant windowed).
"""
from repro_torch.models.config import ModelConfig
from .base import register

CFG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    block_pattern=("moe",),
    num_experts=32,
    experts_per_tok=8,
    tie_embeddings=True,
))
