"""Qwen1.5-MoE-A2.7B: 60 routed experts top-4 + 4 shared (d_ff 1408/expert).
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from .base import ModelConfig, register

register(
    ModelConfig(
        name="qwen2-moe-a2.7b", family="moe", num_layers=24, d_model=2048,
        num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=151936,
        qkv_bias=True, moe_num_experts=60, moe_top_k=4, moe_num_shared=4,
        moe_d_ff=1408),
    smoke=ModelConfig(
        name="qwen2-moe-a2.7b", family="moe", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=32, vocab_size=256, head_dim=16,
        qkv_bias=True, moe_num_experts=8, moe_top_k=4, moe_num_shared=2,
        moe_d_ff=32),
)
