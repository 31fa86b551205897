"""Config registry: ``get_config(arch)`` + reduced smoke variants.

Port of ``repro/configs/__init__.py``: the configs are plain dataclasses,
copied file for file; the registry imports ``repro_torch.configs.<m>``.
"""
from __future__ import annotations

import dataclasses

from .base import FULL_ATTENTION_SKIPS, SHAPES, ModelConfig, ShapeConfig

_MODULES = [
    "kimi_k2_1t_a32b", "qwen3_moe_30b_a3b", "rwkv6_1_6b", "whisper_base",
    "recurrentgemma_2b", "internvl2_76b", "qwen3_4b", "starcoder2_3b",
    "mistral_large_123b", "yi_9b",
]

REGISTRY: dict[str, ModelConfig] = {}
for _m in _MODULES:
    cfg = __import__(f"repro_torch.configs.{_m}", fromlist=["CONFIG"]).CONFIG
    REGISTRY[cfg.name] = cfg

ARCHS = list(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {ARCHS}")
    return REGISTRY[name]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, honoring per-arch skips."""
    for a in ARCHS:
        cfg = REGISTRY[a]
        for s in SHAPES.values():
            skipped = s.name in cfg.skip_shapes
            if skipped and not include_skipped:
                continue
            yield a, s.name, skipped


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: tiny dims, few layers/experts, CPU-safe
    fp32.  The full configs are touched only by the dry-run (abstract)."""
    cfg = get_config(name)
    per = len(cfg.block_pattern)
    small = dict(
        n_layers=max(2 * per, 2 if per == 1 else per) + (1 if per > 1 else 0),
        d_model=64, n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_head=16, d_ff=128, vocab=256, dtype="float32",
        fsdp=False, remat=False, opt_state_dtype="float32",
        optimizer="adamw",
    )
    if cfg.n_experts:
        small.update(n_experts=8, experts_per_token=2)
    if cfg.family == "encdec":
        small.update(encoder_layers=2, encoder_frames=16)
    if cfg.frontend == "vision_stub":
        small.update(n_patches=4)
    if cfg.window:
        small.update(window=8)
    if cfg.d_rnn:
        small.update(d_rnn=64)
    return dataclasses.replace(cfg, **small)
