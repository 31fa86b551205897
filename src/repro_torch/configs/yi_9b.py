"""Yi-9B — llama-arch GQA (arXiv:2403.04652) [hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11_008,
    vocab=64_000,
    skip_shapes=("long_500k",),
)
