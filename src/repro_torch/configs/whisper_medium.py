"""Whisper-medium: 24L encoder + 24L decoder with cross-attention; the conv
audio frontend is a STUB (precomputed frame embeddings, 1500 frames).
Sinusoidal positions (no RoPE). [arXiv:2212.04356]"""
from .base import ModelConfig, register

register(
    ModelConfig(
        name="whisper-medium", family="encdec", num_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=51865,
        norm="layernorm", use_rope=False, cross_attention=True,
        encoder_layers=24, encoder_seq=1500, frontend="audio_stub",
        tie_embeddings=True),
    smoke=ModelConfig(
        name="whisper-medium", family="encdec", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        norm="layernorm", use_rope=False, cross_attention=True,
        encoder_layers=2, encoder_seq=24, frontend="audio_stub",
        tie_embeddings=True),
)
