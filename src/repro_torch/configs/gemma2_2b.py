"""Gemma-2-2B [arXiv:2408.00118]: alternating local/global attention, softcaps.

26 layers (13 (local, global) periods), d_model=2304, 8H (GQA kv=4,
head_dim 256), d_ff=9216, vocab=256000, window 4096, attn softcap 50,
final-logit softcap 30, GeGLU, embedding scale.
"""
from repro_torch.models.config import ModelConfig
from .base import register

CFG = register(ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    block_pattern=("local", "attn"),
    window_size=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    activation="gelu",
    embed_scale=True,
    tie_embeddings=True,
))
