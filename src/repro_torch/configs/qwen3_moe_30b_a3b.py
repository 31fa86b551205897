"""Qwen3-30B-A3B MoE [hf:Qwen/Qwen3-30B-A3B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab=151_936, n_experts=128, experts_per_token=8,
    qk_norm=True, moe_mode="ep", microbatches=4,
    skip_shapes=("long_500k",),
)
