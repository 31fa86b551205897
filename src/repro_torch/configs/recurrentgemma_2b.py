"""RecurrentGemma-2B — RG-LRU + local attention, 1:2 ratio
(arXiv:2402.19427) [hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256_000, window=2048, d_rnn=2560,
    block_pattern=("rglru", "rglru", "local"),
    # bounded state (RG-LRU + 2k window): long_500k runs
)
