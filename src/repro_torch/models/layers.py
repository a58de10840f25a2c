"""Model building blocks — the dense path of ``repro.models.layers`` in torch.

Plain functions on tensors over a parameter dict with the JAX package's
shapes (``wq`` is (d, h, hd), ``wo`` is (h, hd, d), ...), so parameters
carry over by copy (``repro_torch.models.convert``).  Compute dtype is
``cfg.dtype``, parameter dtype ``cfg.param_dtype``; each weight is cast to
the compute dtype where it is used, as in the JAX package, which is a no-op
for weights already held in the compute dtype (``model.serving_params``).
MoE, SSM and cross-attention port with their model families.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops

Params = dict


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ------------------------------------------------------------------- norms
def norm_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
        return (xf * p["scale"].float()).to(x.dtype)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + 1e-5)
    if cfg.norm == "layernorm":
        xf = xf * p["scale"].float() + p["bias"].float()
    return xf.to(x.dtype)


# -------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                     # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention
def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    cdt = compute_dtype(cfg)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    return q, k, v


def best_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target (chunked-scan block size)."""
    c = min(s, target)
    while s % c:
        c -= 1
    return c


def _sdpa_chunked(q, k, v, *, causal: bool, q_chunk: int = 512) -> torch.Tensor:
    """Query-chunked softmax attention with GQA; memory O(B·H·Cq·S).

    q: (B, Sq, H, Dh); k, v: (B, Skv, Hkv, Dh).  H = G·Hkv.  Scores are
    taken in q's dtype, softmax in fp32, and the weights cast back to q's
    dtype before the P.V product, as in the JAX package.
    """
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(dh)
    cq = best_chunk(sq, q_chunk)
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    kpos = torch.arange(skv, device=q.device)
    outs = []
    for c0 in range(0, sq, cq):
        qi = q[:, c0:c0 + cq]
        logits = torch.einsum("bqhd,bkhd->bhqk", qi, k).float() * scale
        if causal:
            qpos = c0 + torch.arange(cq, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            logits = torch.where(mask[None, None], logits, -1e30)
        w = torch.softmax(logits, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", w, v))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def attn_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
               positions: torch.Tensor, *, causal: bool = True,
               return_kv: bool = False):
    """Self-attention over a full sequence (prefill).

    The kernel gate is the JAX package's: flash attention runs when the
    kernels are on, the attention is causal and the sequence is at least
    128 long; otherwise the chunked einsum path runs.
    """
    q, k, v = _qkv(cfg, p, x)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cfg.use_kernels and causal and q.shape[1] >= 128:
        out = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), causal=True)
    else:
        out = _sdpa_chunked(q, k, v, causal=causal)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(compute_dtype(cfg)))
    if return_kv:
        return y, (k, v)
    return y


def attn_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor):
    """Single-token decode. x: (B, 1, D); cache: (B, Smax, Hkv, Dh); pos: (B,).

    The new k, v are written into the cache tensors in place (row ``b`` at
    position ``pos[b]``), where the JAX package returns updated copies; the
    cache tensors are returned all the same.
    """
    cdt = compute_dtype(cfg)
    q, k, v = _qkv(cfg, p, x)
    if cfg.use_rope:
        q = rope(q, pos[:, None], cfg.rope_theta)
        k = rope(k, pos[:, None], cfg.rope_theta)
    rows = torch.arange(x.shape[0], device=x.device)
    cache_k[rows, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, pos] = v[:, 0].to(cache_v.dtype)

    b, _, h, dh = q.shape
    hkv = cache_k.shape[2]
    g = h // hkv
    qg = q.reshape(b, 1, hkv, g, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, cache_k).float()
    logits = logits / math.sqrt(dh)
    kpos = torch.arange(cache_k.shape[1], device=x.device)
    mask = kpos[None, :] <= pos[:, None]                  # (B, Smax)
    logits = torch.where(mask[:, None, None, None, :], logits, -1e30)
    w = torch.softmax(logits, dim=-1).to(cdt)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, cache_v).reshape(b, 1, h, dh)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cdt))
    return y, (cache_k, cache_v)


# ---------------------------------------------------------------------- MLP
def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP (the gelu MLP of the encoder-decoder family ports with it)."""
    cdt = compute_dtype(cfg)
    h = F.silu(x @ p["w_gate"].to(cdt)) * (x @ p["w_up"].to(cdt))
    return h @ p["w_down"].to(cdt)
