"""Whisper-small [arXiv:2212.04356]: encoder-decoder, audio frontend stubbed.

12 encoder + 12 decoder layers, d_model=768, 12H (MHA kv=12, head_dim 64),
d_ff=3072, vocab=51865, LayerNorm + learned positions + GELU, non-gated MLP.
The mel+conv frontend is a stub: input_specs provides frame embeddings.
"""
from repro_torch.models.config import ModelConfig
from .base import register

CFG = register(ModelConfig(
    name="whisper-small",
    arch_type="audio",
    num_layers=12,
    encoder_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    norm_style="layernorm",
    pos_embed="learned",
    max_position=32_768,
    activation="gelu",
    gated_ffn=False,
    frontend="audio",
    tie_embeddings=True,
))
