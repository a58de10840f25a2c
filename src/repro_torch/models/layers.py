"""Model building blocks — ``repro.models.layers`` in torch: norms, RoPE,
self- and cross-attention, the SwiGLU and gelu MLPs, the MoE and the
Mamba2 (SSD) layer.

Plain functions on tensors over a parameter dict with the JAX package's
shapes (``wq`` is (d, h, hd), ``wo`` is (h, hd, d), ...), so parameters
carry over by copy (``repro_torch.models.convert``).  Compute dtype is
``cfg.dtype``, parameter dtype ``cfg.param_dtype``; each weight is cast to
the compute dtype where it is used, as in the JAX package, which is a no-op
for weights already held in the compute dtype (``model.serving_params``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.moe import moe as moe_ops
from repro_torch.kernels.ssd import ssd as ssd_ops

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
    """Self-attention over a full sequence (training, prefill, the
    encoder).

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


def cross_attn_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     enc_k: torch.Tensor, enc_v: torch.Tensor) -> torch.Tensor:
    """Cross-attention (the encoder-decoder's decoder): x (B, Sq, D), Sq = 1
    at decode, against the encoder's k, v (B, encoder_seq, Hkv, Dh) from
    :func:`cross_kv`.  Not causal, so it takes the chunked einsum path, as
    the reference's."""
    cdt = compute_dtype(cfg)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
    out = _sdpa_chunked(q, enc_k, enc_v, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cdt))


def cross_kv(cfg: ModelConfig, p: Params, enc_out: torch.Tensor):
    """The cross-attention's k, v (B, encoder_seq, Hkv, Dh) of the encoder
    output (B, encoder_seq, D)."""
    cdt = compute_dtype(cfg)
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(cdt))
    if cfg.qkv_bias:
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    return k, v


# ---------------------------------------------------------------------- MLP
def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP, or, where ``w_gate`` is absent (the encoder-decoder
    family's), the gelu MLP: gelu's tanh form, ``jax.nn.gelu``'s default,
    not torch's exact erf."""
    cdt = compute_dtype(cfg)
    up = x @ p["w_up"].to(cdt)
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(cdt)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"].to(cdt)


# ---------------------------------------------------------------------- MoE
def moe_apply(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> tuple[torch.Tensor, tuple[torch.Tensor, moe_ops.Routing]]:
    """Sort-based dropping MoE, one dispatch group (the reference's
    ``moe_apply`` without a mesh).  x (B, S, D) -> (out (B, S, D), (the
    router's fp32 probs (B·S, E), the routing)): :func:`moe_aux_loss` takes
    the pair; ``routing.stats[-1]`` is the count of dropped entries.

    fp32 router logits, softmax, ``topk`` and gates renormalised in fp32;
    the capacity routing, dispatch and ordered combine through
    ``kernels/moe`` (the kernel on the card, the plain version on the CPU),
    the dispatch and combine differentiable through their backward entries
    (the routing carries no gradient); the expert SwiGLU as batched
    products over (E, cap, D); the shared experts' MLP added in the compute
    dtype."""
    cdt = compute_dtype(cfg)
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    n = b * s
    xf = x.reshape(n, d)
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, top_e = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    cap = moe_ops.capacity(n, k, e, cfg.capacity_factor)
    r = moe_ops.route(top_e, e, cap, distinct=True)
    h = moe_ops.dispatch(xf.to(cdt), r).view(e, cap, d)
    hg = F.silu(torch.bmm(h, p["w_gate"].to(cdt)))
    hu = torch.bmm(h, p["w_up"].to(cdt))
    ho = torch.bmm(hg * hu, p["w_down"].to(cdt))
    out = moe_ops.combine(ho.view(e * cap, d), r, gate_vals)
    if cfg.moe_num_shared:
        out = out + mlp_apply(cfg, p["shared"], xf.to(cdt))
    return out.view(b, s, d), (probs, r)


def moe_aux_loss(cfg: ModelConfig,
                 routed: tuple[torch.Tensor, moe_ops.Routing]) -> torch.Tensor:
    """The Switch aux loss of one MoE layer from :func:`moe_apply`'s
    (probs, routing): E · Σ_e density_e · mean prob_e, the density from
    each token's first choice (the reference's ``:286-287``), a constant
    to autograd, so the gradient flows through the probs alone.  Serving
    does not read it; training does (``model.train_loss``)."""
    probs, r = routed
    e = cfg.moe_num_experts
    density = F.one_hot(r.top_e[:, 0].long(), e).float().mean(0)
    return e * torch.sum(density * probs.mean(0))


# ------------------------------------------------------------- Mamba2 (SSD)
#: the profiler spans of the SSD recurrence: ``ssm_apply``'s chunk scan and
#: ``ssm_decode``'s state update and readout (the projections, the conv and
#: the gated norm around them are not in them)
SCAN_SPAN, STEP_SPAN = "ssd.scan", "ssd.step"


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time. x: (B, S, C); w: (cw, C); the
    taps summed in order i = 0 ... cw-1, as the reference's ``sum``."""
    cw, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    acc = pad[:, 0:s] * w[0]
    for i in range(1, cw):
        acc = acc + pad[:, i:i + s] * w[i]
    return acc


def _gated_rmsnorm(p: Params, x: torch.Tensor, z: torch.Tensor
                   ) -> torch.Tensor:
    xf = (x * F.silu(z)).float()
    xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
    return (xf * p["scale"].float()).to(x.dtype)


def _ssm_in(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """The input projections z, x, B, C and dt of x (B, S, D)."""
    cdt = compute_dtype(cfg)
    return tuple(x @ p[name].to(cdt)
                 for name in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _ssm_out(cfg: ModelConfig, p: Params, y: torch.Tensor, xh: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    """The skip ``D · x``, the gated norm and the output projection: y and
    xh (B, S, nh, hd), z (B, S, d_inner) -> (B, S, D)."""
    cdt = compute_dtype(cfg)
    b, s = y.shape[:2]
    y = y + xh * p["D"][None, None, :, None].to(cdt)
    y = _gated_rmsnorm(p["norm"], y.reshape(b, s, cfg.ssm_d_inner), z)
    return y @ p["w_out"].to(cdt)


def ssm_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
              return_state: bool = False):
    """Chunked SSD (state-space duality) forward over a full sequence, the
    reference's ``ssm_apply``.

    x: (B, S, D).  The projections, the causal conv and the gated norm are
    torch ops; the recurrence over chunks of ``lc = min(ssm_chunk, S)``
    steps is ``kernels/ssd``'s scan (``ssd_sm90.cu`` on the card, the plain
    version on the CPU; differentiable): within a chunk decay-masked
    matrix products, across chunks the (B, nh, hd, ns) state in the compute
    dtype.  S is padded to a multiple of ``lc`` with steps of dt = 0, which
    leave the state as it is.  With ``return_state`` also returns
    (the final state, the conv tail): the last cw - 1 steps of the
    projections before the conv, laid out [x (d_inner), B (ns), C (ns)],
    which the decode cache holds.
    """
    cdt = compute_dtype(cfg)
    b, s_in, _ = x.shape
    nh, hd, cw = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_conv_width
    lc = min(cfg.ssm_chunk, s_in)
    s = -(-s_in // lc) * lc
    if return_state and s_in < cw - 1:
        raise ValueError(f"a prompt of {s_in} steps holds no conv tail of "
                         f"{cw - 1}")
    if s != s_in:
        x = F.pad(x, (0, 0, 0, s - s_in))
    z, xp, Bp, Cp, dt = _ssm_in(cfg, p, x)
    xin = F.silu(_causal_conv(xp, p["conv_x"].to(cdt)))
    Bmat = F.silu(_causal_conv(Bp, p["conv_B"].to(cdt)))
    Cmat = F.silu(_causal_conv(Cp, p["conv_C"].to(cdt)))
    dt = F.softplus(dt.float() + p["dt_bias"].float())            # (B, S, nh)
    valid = torch.arange(s, device=x.device) < s_in
    dt = dt * valid[None, :, None]                    # freeze padded steps
    A = -torch.exp(p["A_log"].float())                            # (nh,)
    xh = xin.reshape(b, s, nh, hd)
    with torch.profiler.record_function(SCAN_SPAN):
        y, state = ssd_ops.scan(dt, xh, Bmat, Cmat, A, lc)
    out = _ssm_out(cfg, p, y[:, :s_in], xh[:, :s_in], z[:, :s_in])
    if not return_state:
        return out
    tail = torch.cat([t[:, s_in - (cw - 1):s_in] for t in (xp, Bp, Cp)],
                     dim=-1)
    return out, (state, tail)


def ssm_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
               state: torch.Tensor, conv: torch.Tensor):
    """Single-token SSD step, the reference's ``ssm_decode``.  x: (B, 1,
    D); state (B, nh, hd, ns) and the conv window's last cw - 1 steps
    ``conv`` (B, cw-1, d_inner + 2·ns), both in the compute dtype, are
    updated in place (the reference returns copies) by ``kernels/ssd``'s
    step; returns (out, (state, conv)).  No value goes to the host."""
    cdt = compute_dtype(cfg)
    b = x.shape[0]
    di, ns, nh, hd = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads,
                      cfg.ssm_head_dim)
    cw = cfg.ssm_conv_width
    z, xp, Bp, Cp, dt = _ssm_in(cfg, p, x)
    window = torch.cat([conv, torch.cat([xp, Bp, Cp], dim=-1)], dim=1)

    def dconv(w: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        win, w = window[..., lo:hi], w.to(cdt)
        acc = win[:, 0] * w[0]
        for i in range(1, cw):
            acc = acc + win[:, i] * w[i]
        return F.silu(acc)

    xin = dconv(p["conv_x"], 0, di)                               # (B, di)
    Bv = dconv(p["conv_B"], di, di + ns)
    Cv = dconv(p["conv_C"], di + ns, di + 2 * ns)
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"].float())     # (B, nh)
    xh = xin.reshape(b, nh, hd)
    with torch.profiler.record_function(STEP_SPAN):
        y = ssd_ops.step(state, conv, window, xh, dtv,
                         -torch.exp(p["A_log"].float()), Bv, Cv)
    out = _ssm_out(cfg, p, y[:, None], xh[:, None], z)
    return out, (state, conv)
