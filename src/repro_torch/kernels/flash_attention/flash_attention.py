"""Flash attention on the card: the wrapper of the two CUDA kernels.

The counterpart of the JAX package's Pallas kernel
``repro.kernels.flash_attention.flash_attention.flash_attention_bhsd``.  A
tensor on the CPU takes the plain version (``ref.attention_ref``); a tensor
on the card launches a CUDA kernel or raises.  Which kernel is a plain
function of the dtype (:func:`select_kernel`):

* bfloat16, the serving dtype, launches ``csrc/flash_attention_sm90.cu``:
  wgmma tensor-core products on tiles that TMA brings into shared memory.
  Its probabilities enter the P.V product as bf16, one rounding the bf16
  output's tolerance (2e-2, the JAX kernel tests') absorbs.
* float32 launches ``csrc/flash_attention.cu``, fp32 FMA on the CUDA cores.
  The tensor cores would take fp32 only as TF32, whose 10 mantissa bits
  cannot hold the JAX kernel tests' float32 tolerance of 2e-5.

Every launch adds one to a plain integer counter of its kernel
(:func:`launch_counts`); :func:`launch_count` is their total, so a run can
show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import attention_ref

#: the kernel each dtype launches, and the source it is built from
KERNELS = {torch.bfloat16: "sm90_bf16", torch.float32: "fma"}
SOURCES = {"sm90_bf16": "flash_attention_sm90", "fma": "flash_attention"}
#: dtype codes of the FMA kernel's C interface
FMA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535      # fma: B * H blocks on y; sm90: 128-row q tiles on y
_SM90_ROWS = 128

_launches = dict.fromkeys(SOURCES, 0)


def launch_count() -> int:
    """Launches of both kernels since the last :func:`reset_launch_count`."""
    return sum(_launches.values())


def launch_counts() -> dict[str, int]:
    """Launches of each kernel, by name (``"sm90_bf16"``, ``"fma"``)."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


def select_kernel(dtype: torch.dtype, head_dim: int, kernel: str | None = None
                  ) -> str:
    """The kernel that :func:`launch_bshd` runs for q of ``dtype`` and
    ``head_dim``: the dtype's own (:data:`KERNELS`) unless ``kernel`` names
    one.  The FMA kernel also takes bf16 (the yardstick ``chip_smoke.py``
    times beside the sm90 kernel); the sm90 kernel takes bf16 only.
    Raises on what no kernel takes."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} unsupported; the kernels take "
                         f"{HEAD_DIMS}")
    name = KERNELS.get(dtype) if kernel is None else kernel
    if name not in SOURCES:
        raise TypeError(f"no flash kernel for {dtype} (kernel={kernel!r}); "
                        f"the kernels are {KERNELS}")
    if name == "sm90_bf16" and dtype != torch.bfloat16:
        raise TypeError(f"the sm90 kernel takes bfloat16, not {dtype}")
    if name == "fma" and dtype not in FMA_DTYPES:
        raise TypeError(f"the fma kernel takes {tuple(FMA_DTYPES)}, not {dtype}")
    return name


@functools.cache
def _kernel(name: str):
    lib = build.load(SOURCES[name])
    if name == "sm90_bf16":
        fn = lib.flash_attention_fwd_sm90
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    else:
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _raw_stream(device: int) -> int:
    """The handle of the device's current stream, as PyTorch's own compiled
    kernels read it: ``torch.cuda.current_stream().cuda_stream`` is the same
    number but builds a Stream object first, and at the serving shape the
    host's cost of a call is of the order of the kernel's."""
    return torch._C._cuda_getCurrentRawStream(device)


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q: (B, S, H, D); k, v: (B, S, Hkv, D) with H a multiple of Hkv."""
    qs, kvs = q.shape, k.shape
    if len(qs) != 4 or len(kvs) != 4 or kvs != v.shape:
        raise ValueError(f"expected q (B,S,H,D) and k, v (B,S,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = qs
    kb, ks, hkv, kd = kvs
    if kb != b or ks != s or kd != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, sequence or head dim")
    if h % hkv:
        raise ValueError(f"{h} q heads are not a multiple of {hkv} kv heads")


def launch_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, kernel: str | None = None) -> torch.Tensor:
    """Launch a kernel on (B, S, H, D) q and (B, S, Hkv, D) k, v on the
    card; returns o shaped like q.  ``kernel`` as in :func:`select_kernel`.
    Raises on anything the kernel does not take: another device, dtype or
    head dim, a non-contiguous or misaligned tensor, or a failed launch.
    The checks are few and cheap: at the serving shape the host's cost of
    a call is as long as the kernel."""
    check_shapes(q, k, v)
    dev = q.get_device()
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not (
            dev == k.get_device() == v.get_device()):
        raise ValueError(f"q, k, v are on {q.device}, {k.device}, {v.device}; "
                         "the kernel needs all three on one card")
    if not k.dtype == v.dtype == q.dtype:
        raise TypeError(f"q, k, v are {q.dtype}, {k.dtype}, {v.dtype}; the "
                        "kernel takes one dtype for all three")
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()) or (
            ptrs[0] % 16 or ptrs[1] % 16 or ptrs[2] % 16):
        raise ValueError("q, k, v must be contiguous and 16-byte aligned")
    b, s, h, d = q.shape
    name = select_kernel(q.dtype, d, kernel)
    grid_y = -(-s // _SM90_ROWS) if name == "sm90_bf16" else b * h
    if grid_y > _MAX_GRID_Y:
        raise ValueError(f"{grid_y} blocks on the grid's y axis exceed "
                         f"{_MAX_GRID_Y} for the {name} kernel")
    o = torch.empty_like(q)
    args = [*ptrs, o.data_ptr(), b, h, k.shape[2], s, d]
    if name == "fma":
        args.append(FMA_DTYPES[q.dtype])
    args.append(int(causal))
    fn = _kernel(name)
    if dev == torch.cuda.current_device():
        err = fn(*args, _raw_stream(dev))
    else:                      # the launch goes to the current device
        with torch.cuda.device(dev):
            err = fn(*args, _raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"flash attention ({name}) launch failed: error {err}")
    _launches[name] += 1
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
