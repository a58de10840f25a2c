"""Granite-3.0-2B-base: GQA kv=8. [hf:ibm-granite/granite-3.0-2b-base]"""
from .base import ModelConfig, register

register(
    ModelConfig(
        name="granite-3-2b", family="dense", num_layers=40, d_model=2048,
        num_heads=32, num_kv_heads=8, d_ff=8192, vocab_size=49155,
        head_dim=64, tie_embeddings=True),
    smoke=ModelConfig(
        name="granite-3-2b", family="dense", num_layers=2, d_model=64,
        num_heads=8, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=8,
        tie_embeddings=True),
)
