"""InternVL2-76B backbone: InternLM2-76B decoder (GQA kv=8); ViT frontend is
a STUB — input_specs provide precomputed patch embeddings. [arXiv:2404.16821]"""
from .base import ModelConfig, register

register(
    ModelConfig(
        name="internvl2-76b", family="vlm", num_layers=80, d_model=8192,
        num_heads=64, num_kv_heads=8, d_ff=28672, vocab_size=128256,
        head_dim=128, norm="rmsnorm", frontend="vision_stub",
        vision_tokens=256, rope_theta=1_000_000.0),
    smoke=ModelConfig(
        name="internvl2-76b", family="vlm", num_layers=2, d_model=64,
        num_heads=8, num_kv_heads=1, d_ff=160, vocab_size=256, head_dim=8,
        frontend="vision_stub", vision_tokens=8),
)
