"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12_288, n_heads=96, n_kv_heads=8, d_ff=28_672,
    vocab=32_768,
    optimizer="adafactor", opt_state_dtype="bfloat16", microbatches=2,
    skip_shapes=("long_500k",),
)
