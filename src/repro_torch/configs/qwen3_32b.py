"""Qwen3-32B [hf:Qwen/Qwen3-8B family]: dense, qk-norm, GQA.

64 layers, d_model=5120, 64H (GQA kv=8, head_dim 128), d_ff=25600,
vocab=151936, RMSNorm qk-norm on every attention head.
"""
from repro_torch.models.config import ModelConfig
from .base import register

CFG = register(ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
))
