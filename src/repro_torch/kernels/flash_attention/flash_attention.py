"""Flash attention on the card: the wrapper of ``csrc/flash_attention.cu``.

The counterpart of the JAX package's Pallas kernel
``repro.kernels.flash_attention.flash_attention.flash_attention_bhsd``.  A
tensor on the CPU takes the plain version (``ref.attention_ref``); a tensor
on the card launches the CUDA kernel or raises.  Every launch adds one to a
plain integer counter (:func:`launch_count`), so a run can show that its
path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import attention_ref

#: dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535          # B * H blocks on the grid's y axis

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


@functools.cache
def _kernel():
    fn = build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q: (B, S, H, D); k, v: (B, S, Hkv, D) with H a multiple of Hkv."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q (B,S,H,D) and k, v (B,S,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, sequence or head dim")
    if h % k.shape[2]:
        raise ValueError(f"{h} q heads are not a multiple of {k.shape[2]} kv heads")


def launch_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool) -> torch.Tensor:
    """Launch the kernel on (B, S, H, D) q and (B, S, Hkv, D) k, v on the
    card; returns o shaped like q.  Raises on anything the kernel does not
    take: another device, dtype or head dim, a non-contiguous or misaligned
    tensor, or a failed launch."""
    global _launches
    check_shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}; the kernel needs all "
                             f"three on one card (q is on {q.device})")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes "
                            "float32 or bfloat16, the same for q, k and v")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} unsupported; the kernel takes {HEAD_DIMS}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds {_MAX_GRID_Y}")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                        b, h, k.shape[2], s, d, DTYPES[q.dtype], int(causal),
                        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    _launches += 1
    return o


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True) -> torch.Tensor:
    """q, k, v: (BH, S, D), the same head count (pre-broadcast GQA)."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one (BH, S, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    return launch_bshd(q[:, :, None], k[:, :, None], v[:, :, None],
                       causal=causal)[:, :, 0]
