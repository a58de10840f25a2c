"""Flash attention on the card: the wrapper of the three CUDA kernels.

The counterpart of the JAX package's Pallas kernel
``repro.kernels.flash_attention.flash_attention.flash_attention_bhsd``.  A
tensor on the CPU takes the plain version (``ref.attention_ref``); a tensor
on the card launches a CUDA kernel or raises.  Which kernel is a plain
function of the dtype (:func:`select_kernel`):

* bfloat16, the serving dtype, launches ``csrc/flash_attention_sm90.cu``:
  wgmma tensor-core products on tiles that TMA brings into shared memory.
  Its probabilities enter the P.V product as bf16, one rounding the bf16
  output's tolerance (2e-2, the JAX kernel tests') absorbs.
* float32 launches ``csrc/flash_attention_sm90_fp32.cu``: the same
  tensor-core design in TF32, with every operand split as hi + lo
  (:func:`tf32_round`) and three TF32 products for each fp32 one, which
  holds the JAX kernel tests' float32 tolerance of 2e-5 where one TF32
  product (10 mantissa bits) cannot.  A pre-pass of the same call writes
  k and v^T, split and in the kernel's kv order, into scratch
  (:func:`split_kv_tf32`, plain version :func:`split_kv_tf32_ref`).
* ``kernel="fma"`` launches ``csrc/flash_attention.cu``, fp32 FMA on the
  CUDA cores, for fp32 or bf16: no dtype reaches it by default; it stays
  as the yardstick ``chip_smoke.py`` times beside the tensor-core kernels.

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

#: the kernel each dtype launches, and the source each kernel is built from
KERNELS = {torch.bfloat16: "sm90_bf16", torch.float32: "sm90_fp32"}
SOURCES = {"sm90_bf16": "flash_attention_sm90",
           "sm90_fp32": "flash_attention_sm90_fp32", "fma": "flash_attention"}
#: dtype codes of the FMA kernel's C interface
FMA_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535      # fma: B * H blocks on y; sm90: q tiles on y
#: q rows per block of each tensor-core kernel (its q tiles on grid y)
_Q_ROWS = {"sm90_bf16": 128, "sm90_fp32": 64}
#: the fp32 kernel's kv tile; its scratch pads the kv axis to a multiple
KV_TILE_FP32 = 64
#: kv position p of each group of 8 in the fp32 scratch's v^T holds kv row
#: KV_ORDER[p]: the accumulator columns {2t, 2t + 1} a thread holds are the
#: TF32 A fragment's columns {t, t + 4}
KV_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)

_launches = dict.fromkeys(SOURCES, 0)


def launch_count() -> int:
    """Launches of both kernels since the last :func:`reset_launch_count`."""
    return sum(_launches.values())


def launch_counts() -> dict[str, int]:
    """Launches of each kernel, by name (``"sm90_bf16"``, ``"sm90_fp32"``,
    ``"fma"``); a ``sm90_fp32`` launch is its pre-pass and its kernel."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


def select_kernel(dtype: torch.dtype, head_dim: int, kernel: str | None = None
                  ) -> str:
    """The kernel that :func:`launch_bshd` runs for q of ``dtype`` and
    ``head_dim``: the dtype's own (:data:`KERNELS`) unless ``kernel`` names
    one.  The FMA kernel takes fp32 and bf16 (the yardstick
    ``chip_smoke.py`` times beside the tensor-core kernels); each sm90
    kernel takes its own dtype only.  Raises on what no kernel takes."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} unsupported; the kernels take "
                         f"{HEAD_DIMS}")
    name = KERNELS.get(dtype) if kernel is None else kernel
    if name not in SOURCES:
        raise TypeError(f"no flash kernel for {dtype} (kernel={kernel!r}); "
                        f"the kernels are {KERNELS}")
    if name != "fma" and KERNELS.get(dtype) != name:
        takes = next(dt for dt, n in KERNELS.items() if n == name)
        raise TypeError(f"the {name} kernel takes {takes}, not {dtype}")
    if name == "fma" and dtype not in FMA_DTYPES:
        raise TypeError(f"the fma kernel takes {tuple(FMA_DTYPES)}, not {dtype}")
    return name


@functools.cache
def _kernel(name: str):
    lib = build.load(SOURCES[name])
    if name == "sm90_bf16":
        fn = lib.flash_attention_fwd_sm90
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    elif name == "sm90_fp32":
        fn = lib.flash_attention_fwd_sm90_fp32
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    else:
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _split_kernel():
    fn = build.load(SOURCES["sm90_fp32"]).flash_attention_split_kv_tf32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
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
    grid_y = -(-s // _Q_ROWS[name]) if name in _Q_ROWS else b * h
    if grid_y > _MAX_GRID_Y:
        raise ValueError(f"{grid_y} blocks on the grid's y axis exceed "
                         f"{_MAX_GRID_Y} for the {name} kernel")
    o = torch.empty_like(q)
    if name == "sm90_fp32":    # the pre-pass, then the kernel on its scratch
        scratch = _split_kv(k, v)
        args = [ptrs[0], o.data_ptr(), scratch.data_ptr(), scratch.numel()]
    else:
        args = [*ptrs, o.data_ptr()]
    args += [b, h, k.shape[2], s, d]
    if name == "fma":
        args.append(FMA_DTYPES[q.dtype])
    args.append(int(causal))
    _call(name, _kernel(name), args, dev)
    _launches[name] += 1
    return o


def _call(name: str, fn, args: list, dev: int) -> None:
    """Run a C entry point on ``dev``'s current stream; raise on an error."""
    if dev == torch.cuda.current_device():
        err = fn(*args, _raw_stream(dev))
    else:                      # the launch goes to the current device
        with torch.cuda.device(dev):
            err = fn(*args, _raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"flash attention ({name}) launch failed: error {err}")


def _padded_kv(s: int) -> int:
    return -(-s // KV_TILE_FP32) * KV_TILE_FP32


def _split_kv(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the fp32 kernel's pre-pass on checked k, v on the card; its
    scratch: k hi, k lo, v^T hi, v^T lo, flat."""
    b, s, hkv, d = k.shape
    scratch = torch.empty(4 * b * hkv * _padded_kv(s) * d, dtype=torch.float32,
                          device=k.device)
    _call("sm90_fp32 pre-pass", _split_kernel(),
          [k.data_ptr(), v.data_ptr(), scratch.data_ptr(), scratch.numel(),
           b, hkv, s, d], k.get_device())
    return scratch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as the kernel's ``cvt.rna.tf32.f32``: the low 13 bits 0."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_kv_tf32_ref(k: torch.Tensor, v: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the fp32 kernel's pre-pass.  k, v (B, S, Hkv,
    D) -> kx (2, B * Hkv, S_pad, D) and vt (2, B * Hkv, D, S_pad), [0] the
    TF32 hi and [1] the TF32 lo of each value; S_pad is S rounded up to
    :data:`KV_TILE_FP32` with zero rows, and vt's kv axis is in
    :data:`KV_ORDER` inside each group of 8."""
    b, s, hkv, d = k.shape
    sp = _padded_kv(s)
    kf = torch.zeros((b, hkv, sp, d), dtype=torch.float32, device=k.device)
    vf = torch.zeros_like(kf)
    kf[:, :, :s] = k.transpose(1, 2)
    vf[:, :, :s] = v.transpose(1, 2)
    order = torch.arange(sp, device=k.device).view(-1, 8)[:, list(KV_ORDER)]
    vt = vf[:, :, order.reshape(-1)].transpose(-1, -2)

    def split(x):
        hi = tf32_round(x)
        return torch.stack([hi, tf32_round(x - hi)]).reshape(2, b * hkv,
                                                              *x.shape[2:])
    return split(kf), split(vt)


def split_kv_tf32(k: torch.Tensor, v: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp32 kernel's pre-pass alone, as :func:`split_kv_tf32_ref` lays
    it out: the plain version on the CPU, the pre-pass kernel on the card.
    :func:`launch_bshd` runs it before the fp32 kernel and counts the two
    as one launch of ``sm90_fp32``; this call counts nothing."""
    if k.device.type == "cpu":
        return split_kv_tf32_ref(k, v)
    if k.shape != v.shape or k.dim() != 4 or k.dtype != torch.float32 or (
            v.dtype != torch.float32) or not (
            k.is_contiguous() and v.is_contiguous()) or (
            k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("k, v must be contiguous, 16-byte aligned float32 "
                         "(B, S, Hkv, D) of one shape")
    if k.device != v.device:
        raise ValueError(f"k, v are on {k.device}, {v.device}")
    b, s, hkv, d = k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} unsupported; the kernels take "
                         f"{HEAD_DIMS}")
    sp = _padded_kv(s)
    kx, vt = _split_kv(k, v).view(2, -1).unbind(0)
    return kx.view(2, b * hkv, sp, d), vt.view(2, b * hkv, d, sp)


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
