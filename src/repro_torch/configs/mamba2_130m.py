"""Mamba2-130M: pure SSD (state-space duality) stack, attention-free,
d_state=128. [arXiv:2405.21060]"""
from .base import ModelConfig, register

register(
    ModelConfig(
        name="mamba2-130m", family="ssm", num_layers=24, d_model=768,
        d_ff=0, vocab_size=50280, ssm_state=128, ssm_expand=2,
        ssm_head_dim=64, tie_embeddings=True),
    smoke=ModelConfig(
        name="mamba2-130m", family="ssm", num_layers=2, d_model=64,
        d_ff=0, vocab_size=256, ssm_state=16, ssm_expand=2, ssm_head_dim=16,
        ssm_chunk=8, tie_embeddings=True),
)
