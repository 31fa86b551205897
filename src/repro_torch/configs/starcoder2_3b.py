"""StarCoder2-3B — GQA, RoPE (arXiv:2402.19173) [hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12_288,
    vocab=49_152,
    skip_shapes=("long_500k",),
)
