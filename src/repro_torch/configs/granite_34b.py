"""Granite-34B-code: llama-arch MQA (kv=1) code model. [arXiv:2405.04324; hf]"""
from .base import ModelConfig, register

register(
    ModelConfig(
        name="granite-34b", family="dense", num_layers=88, d_model=6144,
        num_heads=48, num_kv_heads=1, d_ff=24576, vocab_size=49152,
        head_dim=128, norm="layernorm", tie_embeddings=True),
    smoke=ModelConfig(
        name="granite-34b", family="dense", num_layers=2, d_model=64,
        num_heads=8, num_kv_heads=1, d_ff=192, vocab_size=256, head_dim=8,
        norm="layernorm", tie_embeddings=True),
)
