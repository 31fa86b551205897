"""Qwen3-4B — qk_norm, GQA [hf:Qwen/Qwen3-8B family]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
    vocab=151_936, qk_norm=True,
    skip_shapes=("long_500k",),
)
