"""Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family]: dense MHA with QKV bias.

64 layers, d_model=5120, 40H (kv=40, head_dim 128), d_ff=27392, vocab=152064.
"""
from repro_torch.models.config import ModelConfig
from .base import register

CFG = register(ModelConfig(
    name="qwen1.5-32b",
    arch_type="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27_392,
    vocab_size=152_064,
    qkv_bias=True,
    tie_embeddings=False,
))
