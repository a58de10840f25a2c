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
    """q: (B, S, H, Dh); k, v: (B, S, Hkv, Dh) with H = G·Hkv (GQA)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    return fa.launch_bshd(q, k, v, causal=causal)
