"""Config system: architectures (assigned pool) × input shapes."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0            # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_mode: str = "ep"       # ep (all_to_all expert parallel) | tp (sliced experts)
    capacity_factor: float = 1.25
    # attention flavor
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: int = 0            # sliding-window size for "local" blocks
    block_pattern: tuple = ("attn",)   # repeated over depth
    # recurrent dims
    d_rnn: int = 0             # RG-LRU width (0 -> d_model)
    # enc-dec / multimodal
    encoder_layers: int = 0
    encoder_frames: int = 0    # fixed encoder length (whisper: 1500)
    frontend: str = "none"     # none | audio_stub | vision_stub
    n_patches: int = 0         # vision_stub prompt patches
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # numerics / distribution
    dtype: str = "bfloat16"
    fsdp: bool = True
    remat: bool = True
    optimizer: str = "adamw"
    opt_state_dtype: str = "float32"
    adafactor_momentum: bool = True
    grad_accum_dtype: str = "float32"
    microbatches: int = 1   # train grad-accumulation splits
    # which shapes are lowerable for this arch ("" = all); see DESIGN.md
    skip_shapes: tuple = ()

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab padded to a multiple of 128 so the
        vocab dim shards over any mesh axis (MaxText-style); padded logits
        are masked in Model.logits."""
        return ((self.vocab + 127) // 128) * 128

    def pattern(self) -> list[str]:
        """Per-layer block kinds, pattern repeated/truncated to n_layers."""
        p = list(self.block_pattern)
        return [p[i % len(p)] for i in range(self.n_layers)]

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# Architectures whose every block attends globally (quadratic, unbounded KV)
# cannot run the 512k-decode cell; DESIGN.md §Arch-applicability records the
# skip.  SSM/hybrid archs run it with O(1)/windowed state.
FULL_ATTENTION_SKIPS = ("long_500k",)
