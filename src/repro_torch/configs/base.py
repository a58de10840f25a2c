"""Model/config system — every assigned architecture is a ``ModelConfig``.

Families: dense | moe | ssm | hybrid | encdec | vlm.  A copy of the JAX
package's ``repro.configs.base`` (the port imports nothing of it), with the
kernel switch renamed: ``use_kernels`` selects the hand-written CUDA kernels.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0               # 0 -> d_model // num_heads
    qkv_bias: bool = False          # qwen2-style attention bias
    norm: str = "rmsnorm"           # rmsnorm | layernorm | np_layernorm (olmo)
    use_rope: bool = True
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0         # always-active shared experts
    moe_every: int = 1              # MoE replaces MLP every Nth layer
    moe_d_ff: int = 0               # per-expert hidden size (0 -> d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0             # hybrid: attention layer every Nth (jamba: 8)
    attn_offset: int = 4            # index of attn layer within the period
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500         # whisper audio frames after conv stub
    cross_attention: bool = False
    # --- modality frontend stubs ---
    frontend: str = "none"          # none | audio_stub | vision_stub
    vision_tokens: int = 256        # precomputed patch embeds prepended (vlm)
    # --- numerics / training ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"             # none | dots | full
    use_kernels: bool = False       # hand-written CUDA kernels; on for the card
    vocab_pad_multiple: int = 256   # embed/lm_head padded for clean sharding
    train_microbatches: int = 1     # gradient-accumulation microbatches
    seq_parallel: bool = False      # shard layer-boundary residuals on tp
    fold_model_into_dp: bool = False  # no TP structure -> use the model
                                    # axis as extra data parallelism
                                    # (Megatron-SP-style; saves remat memory)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab_size + m - 1) // m * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def moe_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe_num_experts == 0:
            return False
        return layer_idx % self.moe_every == (self.moe_every - 1)

    def is_attn_layer(self, layer_idx: int) -> bool:
        """Hybrid (jamba): attention at ``attn_offset`` within each period."""
        if self.family not in ("hybrid",):
            return self.family != "ssm"
        return layer_idx % self.attn_every == self.attn_offset

    def num_params(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs and docs)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d  # embed
        if not self.tie_embeddings:
            total += v * d
        dec = self.num_layers
        for i in range(dec):
            if self.family == "ssm" or (self.family == "hybrid" and not self.is_attn_layer(i)):
                di, ns, nh = self.ssm_d_inner, self.ssm_state, self.ssm_num_heads
                total += d * (2 * di + 2 * ns + nh) + di * d  # in/out proj (+B,C,dt)
                total += self.ssm_conv_width * (di + 2 * ns) + 2 * nh  # conv, A, D
            else:
                q = self.num_heads * hd
                kv = self.num_kv_heads * hd
                total += d * (q + 2 * kv) + q * d
                if self.qkv_bias:
                    total += q + 2 * kv
            if self.family in ("dense", "vlm", "encdec") or \
               (self.family in ("moe", "hybrid") and not self.is_moe_layer(i)):
                if self.d_ff:
                    total += 3 * d * self.d_ff  # SwiGLU
            elif self.is_moe_layer(i):
                e = self.moe_num_experts + self.moe_num_shared
                total += 3 * d * self.moe_ff * e + d * self.moe_num_experts
            total += 2 * d if self.norm != "np_layernorm" else 0
        for _ in range(self.encoder_layers):
            q = self.num_heads * hd
            total += d * (q + 2 * self.num_kv_heads * hd) + q * d + 3 * d * self.d_ff
            if self.cross_attention:  # decoder cross-attn blocks counted here
                total += d * (q + 2 * self.num_kv_heads * hd) + q * d
        return total

    def active_params(self) -> int:
        """Active params per token (MoE: only top-k + shared experts)."""
        if self.moe_num_experts == 0:
            return self.num_params()
        full = self.num_params()
        moe_layers = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        inactive = (self.moe_num_experts - self.moe_top_k)
        full -= moe_layers * 3 * self.d_model * self.moe_ff * inactive
        return full


_REGISTRY: dict[str, "ModelConfig"] = {}
_SMOKE: dict[str, "ModelConfig"] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    return _SMOKE[name]


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
