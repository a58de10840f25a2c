"""Model-facing wrapper: (B, S, H, Dh) GQA layout -> flash kernel.

The counterpart of ``repro.kernels.flash_attention.ops.flash_attention``.
On the card the kernel reads kv head ``h // (H / Hkv)`` directly, so the kv
heads are never repeated in memory; the plain version repeats them, as the
JAX wrapper does, and folds (B, H) for ``attention_ref``.
"""
from __future__ import annotations

import torch

from . import flash_attention as fa
from .ref import attention_ref


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """The plain version of :func:`flash_attention`."""
    fa.check_shapes(q, k, v)
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    kb = k.repeat_interleave(g, dim=2)
    vb = v.repeat_interleave(g, dim=2)

    def fold(x):
        return x.transpose(1, 2).reshape(b * h, s, dh)

    out = attention_ref(fold(q), fold(kb), fold(vb), causal=causal)
    return out.reshape(b, h, s, dh).transpose(1, 2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, Dh); k, v: (B, S, Hkv, Dh) with H = G·Hkv (GQA).

    Forward only, as the reference's Pallas kernel (it has no VJP): a call
    that autograd would record, on either device, raises ``RuntimeError``
    rather than return an output whose q, k and v get no gradient.  A
    trainer takes the chunked attention (``use_kernels`` off), as the
    reference's trainer does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward only (no backward "
                           "kernel, as the reference's has no VJP): train "
                           "with use_kernels=False, the chunked attention")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    return fa.launch_bshd(q, k, v, causal=causal)
