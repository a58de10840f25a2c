"""OLMo-1B: non-parametric LayerNorm, MHA (kv=16), tied embeddings.
[arXiv:2402.00838; hf]"""
from .base import ModelConfig, register

register(
    ModelConfig(
        name="olmo-1b", family="dense", num_layers=16, d_model=2048,
        num_heads=16, num_kv_heads=16, d_ff=8192, vocab_size=50304,
        norm="np_layernorm", tie_embeddings=True),
    smoke=ModelConfig(
        name="olmo-1b", family="dense", num_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        norm="np_layernorm", tie_embeddings=True),
)
