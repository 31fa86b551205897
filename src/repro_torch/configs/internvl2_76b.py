"""InternVL2-76B — InternViT frontend (stub patch embeddings) + InternLM2
backbone (arXiv:2404.16821)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28_672,
    vocab=128_256, frontend="vision_stub", n_patches=256, microbatches=2,
    optimizer="adafactor", opt_state_dtype="bfloat16",
    skip_shapes=("long_500k",),
)
