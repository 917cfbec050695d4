"""xLSTM-1.3B [arXiv:2405.04517]: sLSTM + mLSTM blocks (7:1 ratio).

48 blocks (6 (7x mLSTM + 1x sLSTM) periods), d_model=2048, 4 heads,
projection factor 1.0 (d_ff=0 — width lives in the cell projections;
factor chosen to match the 1.3B parameter budget),
vocab=50304.
"""
from repro_torch.models.config import ModelConfig
from .base import register

CFG = register(ModelConfig(
    name="xlstm-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    xlstm_proj_factor=1.0,
    tie_embeddings=True,
))
