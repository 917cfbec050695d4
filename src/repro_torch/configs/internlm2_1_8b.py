"""InternLM2-1.8B [arXiv:2403.17297]: dense GQA.

24 layers, d_model=2048, 16H (GQA kv=8, head_dim 128), d_ff=8192, vocab=92544.
"""
from repro_torch.models.config import ModelConfig
from .base import register

CFG = register(ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_544,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
))
