"""The contention fixpoint on the card: the wrapper of
``csrc/contention_sm90.cu``.

The counterpart of the JAX package's jitted whole-bucket fixpoint
``repro.sim.batch._contended_durations``: a bucket of B padded plans with
their transfer sets (the fields of ``repro_torch.sim.batch.ContendedBucket``)
gives (B, T_pad) float64 transfer durations at the replay/fluid fixpoint.
A tensor on the CPU takes the plain version (``ref.contended_durations_ref``);
a tensor on the card launches the kernel or raises.  The kernel keeps each
transfer's state in registers, runs one reduction a filling round that also
carries the event's min, and runs one warp a plan up to 32 transfers.

Every launch adds one to the counter (:func:`launch_count`).

Inputs: ``order`` (B, n_pad), ``pred`` and ``pred_tid`` (B, n_pad, P_pad)
int32 (-1 = none), ``pred_mask`` (B, n_pad, P_pad) bool, ``times`` (B,
n_pad) float64, ``src``, ``up`` and ``dn`` (B, T_pad) int32, ``size`` (B,
T_pad) float64, ``t_mask`` (B, T_pad) bool, ``capacity`` (B,) float64.
:func:`contended_durations` checks the index ranges on the card (one wait)
and returns the durations; :func:`launch` is the bare launch, which checks
layouts only and also returns the kernel's per-plan int32 counts, in the
order of :data:`COUNT_NAMES`: rounds run, events run, filling rounds run,
replay steps, and the events whose min rode on their last filling round's
reduction.  :func:`launch_split` is the same launch through the kernel's
split variant, which also returns the clock cycles of each phase
(:data:`PHASES`), for timing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import contended_durations_ref

__all__ = ["COUNT_NAMES", "MAX_LINKS", "MAX_T_PAD", "PHASES", "SMEM_LIMIT",
           "check_indices", "check_inputs", "contended_durations",
           "contended_durations_ref", "launch", "launch_count",
           "launch_split", "reset_launch_count", "smem_bytes", "threads"]

SOURCE = "contention_sm90"   # the kernel's source under ``csrc/``
COUNT_NAMES = ("rounds", "events", "fills", "steps", "merged")
#: the phases of a split launch's cycles (``contention_common.cuh``)
PHASES = ("replay", "activity", "count", "inc", "rate", "event", "remain")
MAX_LINKS = 8                # links a plan may use (a pair per resource type)
SMEM_LIMIT = 232448          # 227 KB, the most a block may take on the H100
# The kernel's block (csrc/contention_sm90.cu), a function of T_pad:
# one warp up to 32 transfers, then a thread a transfer up to
# BLOCK_THREADS, then BLOCK_THREADS with 2 a thread, past 2 BLOCK_THREADS
# transfers WIDE_THREADS with 8 or 16 a thread (their registers).
MAX_WARPS = 16               # its reduction buffers
BLOCK_THREADS = 512
WIDE_THREADS = 256
MAX_T_PAD = WIDE_THREADS * 16    # its most transfers a plan
_MAX_BLOCKS = 2 ** 31 - 1

_launches = 0

_INT = ("order", "pred", "pred_tid", "src", "up", "dn")
_BOOL = ("pred_mask", "t_mask")
NAMES = ("order", "pred", "pred_mask", "pred_tid", "times", "src", "size",
         "up", "dn", "t_mask", "capacity")


def launch_count() -> int:
    """Launches of the kernel since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def threads(t_pad: int) -> int:
    """Threads of one block: one warp up to 32 transfers, then T_pad
    rounded up to a warp, at most :data:`BLOCK_THREADS`, and
    :data:`WIDE_THREADS` past twice that."""
    t = -(-t_pad // 32) * 32
    if t_pad <= 32:
        return 32
    return WIDE_THREADS if t_pad > 2 * BLOCK_THREADS else min(t, BLOCK_THREADS)


def smem_bytes(n_pad: int, p_pad: int, t_pad: int) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out:
    float64 finish times (n_pad + 1, a zero cell), step times, slot delays
    and the transfers' durations, the reductions' buffers (a double and four
    words a warp, twice), and the step records' task, slot and transfer
    indices."""
    slots = n_pad * p_pad
    doubles = (n_pad + 1) + n_pad + slots + t_pad + 2 * MAX_WARPS
    ints = 2 * MAX_WARPS * 4 + n_pad + 2 * slots
    return (8 * doubles + 4 * ints + 7) & ~7


@functools.cache
def _kernel(split: bool):
    entry = "split" if split else "durations"
    fn = getattr(build.load(SOURCE), f"{SOURCE}_{entry}_f64")
    fn.argtypes = ([ctypes.c_void_p] * (14 if split else 13)
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_inputs(order, pred, pred_mask, pred_tid, times, src, size, up, dn,
                 t_mask, capacity) -> None:
    """Shapes, dtypes and one device for the eleven inputs."""
    args = dict(zip(NAMES, (order, pred, pred_mask, pred_tid, times, src,
                            size, up, dn, t_mask, capacity)))
    if order.dim() != 2 or pred.dim() != 3 or size.dim() != 2:
        raise ValueError(f"expected order (B, n), pred (B, n, P), size "
                         f"(B, T); got {tuple(order.shape)}, "
                         f"{tuple(pred.shape)}, {tuple(size.shape)}")
    B, n = order.shape
    want = {"order": (B, n), "pred": (B, n, pred.shape[2]),
            "pred_mask": tuple(pred.shape), "pred_tid": tuple(pred.shape),
            "times": (B, n), "src": tuple(size.shape), "size": (B, size.shape[1]),
            "up": tuple(size.shape), "dn": tuple(size.shape),
            "t_mask": tuple(size.shape), "capacity": (B,)}
    for name, t in args.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want[name]} (order {tuple(order.shape)}, "
                             f"size {tuple(size.shape)})")
        dtype = (torch.int32 if name in _INT else torch.bool if name in _BOOL
                 else torch.float64)
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the fixpoint takes {dtype}")
        if t.device != order.device:
            raise ValueError(f"{name} is on {t.device} and order on "
                             f"{order.device}")


def check_indices(order, pred, pred_mask, pred_tid, src, up, dn,
                  num_links: int) -> None:
    """Raise unless every order entry, pred slot and producer indexes a task
    of its plan, every transfer slot a transfer, every link id one of
    ``num_links``, and the mask marks exactly the real pred slots."""
    n = order.shape[1]
    T = src.shape[1]
    bad = (((order < 0) | (order >= n)).any() | (pred < -1).any()
           | (pred >= n).any() | (pred_mask != (pred >= 0)).any()
           | (pred_tid < -1).any() | (pred_tid >= T).any()
           | ((src < 0) | (src >= n)).any()
           | ((up < 0) | (up >= num_links) | (dn < 0)
              | (dn >= num_links)).any())
    if bool(bad):
        raise ValueError("order, pred, pred_tid, src or a link id out of "
                         "range, or pred_mask not pred >= 0")


def _launch(args, num_links: int, iters: int, split: bool):
    global _launches
    check_inputs(*args)
    for name, t in zip(NAMES, args):
        if t.device.type != "cuda":
            raise ValueError(
                f"{name} is on {t.device}; the kernel needs the card")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    order, pred, size = args[0], args[1], args[6]
    B, n, P = pred.shape
    T = size.shape[1]
    if not 1 <= num_links <= MAX_LINKS:
        raise ValueError(f"{num_links} links; the kernel takes 1 to "
                         f"{MAX_LINKS}")
    need = smem_bytes(n, P, T)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"a plan of (n_pad, P_pad, T_pad) = ({n}, {P}, {T}) needs {need} "
            f"bytes of shared memory in the kernel, more than the "
            f"{SMEM_LIMIT} a block may have")
    if T > MAX_T_PAD:
        raise ValueError(f"a plan of T_pad {T}: the kernel takes at most "
                         f"{MAX_T_PAD} transfers")
    if B > _MAX_BLOCKS:
        raise ValueError(f"{B} plans exceed the launch grid")
    if B == 0 or n == 0 or T == 0:
        raise ValueError(f"empty bucket: B, n_pad, T_pad = {B}, {n}, {T}")
    dev = order.device
    out = torch.empty((B, T), dtype=torch.float64, device=dev)
    counts = torch.empty((B, len(COUNT_NAMES)), dtype=torch.int32,
                         device=dev)
    cycles = (torch.empty((B, len(PHASES)), dtype=torch.int64, device=dev)
              if split else None)
    pointers = [t.data_ptr() for t in args] + [out.data_ptr(),
                                               counts.data_ptr()]
    if split:
        pointers.append(cycles.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(split)(*pointers, B, n, P, T, num_links, iters, stream)
    if err != 0:
        raise RuntimeError(f"{SOURCE}.cu launch failed: CUDA error {err}")
    _launches += 1
    return out, counts, cycles


def launch(order, pred, pred_mask, pred_tid, times, src, size, up, dn, t_mask,
           capacity, *, num_links: int, iters: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on contiguous tensors on one card, on
    :func:`threads` threads a block; returns the (B, T_pad) float64
    durations and the (B, len(COUNT_NAMES)) int32 counts.  Raises on
    anything of the layout the kernel does not take: another device, a
    non-contiguous tensor, more than :data:`MAX_LINKS` links, a shape whose
    shared memory passes :data:`SMEM_LIMIT`, more than :data:`MAX_T_PAD`
    transfers, or a failed launch.  The indices are the caller's to check
    (:func:`check_indices`)."""
    args = (order, pred, pred_mask, pred_tid, times, src, size, up, dn,
            t_mask, capacity)
    out, counts, _ = _launch(args, num_links, iters, False)
    return out, counts


def launch_split(order, pred, pred_mask, pred_tid, times, src, size, up, dn,
                 t_mask, capacity, *, num_links: int, iters: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`launch` through the kernel's split variant: also returns the
    (B, len(PHASES)) int64 clock cycles that each plan's thread 0 spent in
    each phase of its chain.  For timing only; its durations and counts
    equal :func:`launch`'s."""
    args = (order, pred, pred_mask, pred_tid, times, src, size, up, dn,
            t_mask, capacity)
    return _launch(args, num_links, iters, True)


def contended_durations(order, pred, pred_mask, pred_tid, times, src, size,
                        up, dn, t_mask, capacity, *, num_links: int,
                        iters: int) -> torch.Tensor:
    """(B, T_pad) float64 durations at the fixpoint: the plain version for
    CPU tensors, the kernel for tensors on the card."""
    args = (order, pred, pred_mask, pred_tid, times, src, size, up, dn,
            t_mask, capacity)
    check_inputs(*args)
    if order.device.type == "cpu":
        return contended_durations_ref(*args, num_links, iters)
    check_indices(order, pred, pred_mask, pred_tid, src, up, dn, num_links)
    return launch(*args, num_links=num_links, iters=iters)[0]
