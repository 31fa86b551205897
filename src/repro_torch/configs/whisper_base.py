"""Whisper-base enc-dec; conv/audio frontend is a stub (precomputed frame
embeddings) per the assignment [arXiv:2212.04356]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51_865, frontend="audio_stub", encoder_frames=1500,
    tie_embeddings=True,
    skip_shapes=("long_500k",),  # full-attention decoder
)
