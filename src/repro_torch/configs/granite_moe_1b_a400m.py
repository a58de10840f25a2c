"""Granite-3.0-1B-A400M: 32 experts top-8 (d_ff 512/expert).
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from .base import ModelConfig, register

register(
    ModelConfig(
        name="granite-moe-1b-a400m", family="moe", num_layers=24,
        d_model=1024, num_heads=16, num_kv_heads=8, d_ff=512,
        vocab_size=49155, head_dim=64, moe_num_experts=32, moe_top_k=8,
        moe_d_ff=512, tie_embeddings=True),
    smoke=ModelConfig(
        name="granite-moe-1b-a400m", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=32, vocab_size=256, head_dim=16,
        moe_num_experts=8, moe_top_k=4, moe_d_ff=32, tie_embeddings=True),
)
