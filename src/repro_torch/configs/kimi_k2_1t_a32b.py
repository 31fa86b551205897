"""Kimi K2 — trillion-param MoE (arXiv:2501.kimi2) [paper-table]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
    vocab=163_840, n_experts=384, experts_per_token=8,
    qk_norm=False, moe_mode="ep",
    # 1T params: factored second moment + bf16 states to fit 512×16 GB
    optimizer="adafactor", opt_state_dtype="bfloat16",
    adafactor_momentum=False,     # 1T params: m alone is 2 TB
    grad_accum_dtype="bfloat16",  # fp32 accum would be 16 GB/device
    microbatches=8,               # keeps MoE dispatch buffers ~1 GB
    skip_shapes=("long_500k",),  # full attention (DESIGN.md §Arch-applicability)
)
