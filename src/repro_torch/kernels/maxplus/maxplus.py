"""Tropical (max, +) product on the card: the wrapper of ``csrc/maxplus.cu``.

The counterpart of the JAX package's Pallas kernel
``repro.kernels.maxplus.maxplus.maxplus_matmul``:
``C[i, j] = max_k (A[i, k] + B[k, j])`` in float32, with a leading batch
dimension that one launch covers (the JAX package ``vmap``s the kernel).  A
tensor on the CPU takes the plain version (``ref.maxplus_matmul_ref``); a
tensor on the card launches the CUDA kernel or raises.  Every launch adds
one to a plain integer counter (:func:`launch_count`), so a run can show
that its path went through the kernel.

The kernel's tiles are fixed (128 x 128 x 16) with masked edges, so the
Pallas kernel's block-shape arguments (``bm``, ``bn``, ``bk``, which had to
divide the dims) have no counterpart; neither has ``interpret``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import NEG_INF, maxplus_matmul_ref

__all__ = ["NEG_INF", "INPUT_DTYPES", "launch", "launch_count",
           "maxplus_matmul", "reset_launch_count"]

#: input dtypes the wrapper accepts; each is cast to float32 first, as the
#: JAX package does, and the kernel itself reads float32 only
INPUT_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
_MAX_GRID = 65535            # lanes on grid z, 128-row tiles on grid y

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


@functools.cache
def _kernel():
    fn = build.load("maxplus").maxplus_matmul_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    """a: (m, k) and b: (k, n), or a: (B, m, k) and b: (B, k, n)."""
    if a.dim() not in (2, 3) or b.dim() != a.dim():
        raise ValueError(f"expected (m, k) x (k, n) or (B, m, k) x (B, k, n); "
                         f"got {tuple(a.shape)} x {tuple(b.shape)}")
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(b.shape)} do not "
                         "chain")
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in INPUT_DTYPES:
            raise TypeError(f"{name} is {t.dtype}; maxplus takes {INPUT_DTYPES}")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device} and b on {b.device}")


def launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on (B, m, k) and (B, k, n) contiguous float32
    tensors on one card; returns (B, m, n) float32.  Raises on anything the
    kernel does not take: another device or dtype, a non-contiguous tensor,
    a grid too large, or a failed launch."""
    global _launches
    if a.dim() != 3:
        raise ValueError(f"launch takes (B, m, k) x (B, k, n); got "
                         f"{tuple(a.shape)} x {tuple(b.shape)}")
    check_shapes(a, b)
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs the card")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel reads float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lanes, m, k = a.shape
    n = b.shape[-1]
    if lanes > _MAX_GRID or -(-m // 128) > _MAX_GRID:
        raise ValueError(f"{lanes} lanes of {m} rows exceed the launch grid")
    if max(k, n) >= 2 ** 31:
        raise ValueError(f"k={k}, n={n}: the kernel takes 32-bit dims")
    c = torch.empty((lanes, m, n), dtype=torch.float32, device=a.device)
    if c.numel() == 0:
        return c
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel()(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                        lanes, m, k, n, stream)
    if err != 0:
        raise RuntimeError(f"maxplus_matmul_f32 launch failed: CUDA error {err}")
    _launches += 1
    return c


def maxplus_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[.., i, j] = max_k (A[.., i, k] + B[.., k, j]) in float32, floored at
    NEG_INF.  a: (m, k) or (B, m, k); b: (k, n) or (B, k, n)."""
    check_shapes(a, b)
    if a.device.type == "cpu":
        return maxplus_matmul_ref(a, b)
    batched = a.dim() == 3
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    if not batched:
        a32, b32 = a32[None], b32[None]
    c = launch(a32, b32)
    return c if batched else c[0]
