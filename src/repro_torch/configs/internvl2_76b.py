"""InternVL2-76B [arXiv:2404.16821]: InternViT + LLaMA3-70B-class LM backbone.

LM backbone only (the ViT frontend is a stub per the assignment carve-out):
80 layers, d_model=8192, 64H (GQA kv=8, head_dim 128), d_ff=28672,
vocab=128256.  `num_prefix_embeds` precomputed patch embeddings are fused
early into the sequence (input_specs provides them).
"""
from repro_torch.models.config import ModelConfig
from .base import register

CFG = register(ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    frontend="vision",
    num_prefix_embeds=256,
    rope_theta=500_000.0,
    tie_embeddings=False,
))
