"""Qwen2-1.5B: GQA kv=2 with QKV bias. [arXiv:2407.10671; hf]"""
from .base import ModelConfig, register

register(
    ModelConfig(
        name="qwen2-1.5b", family="dense", num_layers=28, d_model=1536,
        num_heads=12, num_kv_heads=2, d_ff=8960, vocab_size=151936,
        head_dim=128, qkv_bias=True, tie_embeddings=True,
        rope_theta=1_000_000.0),
    smoke=ModelConfig(
        name="qwen2-1.5b", family="dense", num_layers=2, d_model=48,
        num_heads=6, num_kv_heads=2, d_ff=160, vocab_size=256, head_dim=8,
        qkv_bias=True, tie_embeddings=True),
)
