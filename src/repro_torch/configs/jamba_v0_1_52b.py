"""Jamba-v0.1 (52B): hybrid Mamba+attention 1:7 interleave (attention every
8th layer), MoE 16 experts top-2 every 2nd layer. [arXiv:2403.19887; hf]

Adaptation note: Jamba's Mamba-1 blocks are implemented with the SSD (Mamba-2)
chunked formulation, the JAX package's evaluation of the same selective
state-space recurrence, which the port keeps."""
from .base import ModelConfig, register

register(
    ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
        head_dim=128, moe_num_experts=16, moe_top_k=2, moe_every=2,
        attn_every=8, attn_offset=4, ssm_state=16, ssm_expand=2,
        ssm_head_dim=64),
    smoke=ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", num_layers=4, d_model=64,
        num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
        moe_num_experts=4, moe_top_k=2, moe_every=2, attn_every=4,
        attn_offset=2, ssm_state=16, ssm_expand=2, ssm_head_dim=16,
        ssm_chunk=8),
)
