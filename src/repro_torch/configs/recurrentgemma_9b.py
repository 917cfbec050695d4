"""RecurrentGemma-9B [arXiv:2402.19427]: RG-LRU + local attention, 1:2 ratio.

38 layers (12 full (rglru, rglru, local) periods + 2 remainder rglru),
d_model=4096, 16 heads (MQA kv=1, head_dim 256), d_ff=12288, vocab=256000,
local window 2048, GeGLU, Gemma-style embedding scale.
"""
from repro_torch.models.config import ModelConfig
from .base import register

CFG = register(ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local"),
    window_size=2048,
    rnn_width=4096,
    rnn_heads=16,
    activation="gelu",
    embed_scale=True,
    tie_embeddings=True,
))
