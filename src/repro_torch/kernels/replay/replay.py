"""Makespan replay on the card: the wrapper of ``csrc/replay.cu``.

The counterpart of the JAX package's jitted replay
``repro.sim.batch._bucket_makespans``: a bucket of B padded plan DAGs,
each replayed under S realized-time rows, gives a (B, S) float32 array of
makespans.  A tensor on the CPU takes the plain version
(``ref.bucket_makespans_ref``); a tensor on the card launches the CUDA
kernel or raises.  Every launch adds one to a plain integer counter
(:func:`launch_count`), so a run can show that its path went through the
kernel.

Inputs, as ``repro_torch.sim.batch.BatchedPlanDag`` holds them: ``order``
(B, n_pad) int32 topological order; ``pred`` (B, n_pad, P_pad) int32
predecessor slots, filled from the left, -1 after the last real one;
``pred_delay`` (B, n_pad, P_pad) and ``floor`` (B, n_pad) float32; ``times``
(B, S, n_pad) float32.  Any order whose entries index the plan gives the
plain version's answer; the campaign's are topological.
:func:`bucket_makespans` checks the index ranges and the slot filling
(:func:`check_indices`, one wait for the card); :func:`launch` is the bare
launch and checks layouts only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import bucket_makespans_ref

__all__ = ["bucket_makespans", "bucket_makespans_ref", "check_indices",
           "check_inputs", "launch", "launch_count", "reset_launch_count"]

LANES = 32                   # seeds per block (csrc/replay.cu)
_MAX_BLOCKS = 2 ** 31 - 1    # grid x

_launches = 0


def launch_count() -> int:
    """Kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


@functools.cache
def _kernel():
    fn = build.load("replay").replay_makespans_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(order, pred, pred_delay, floor, times) -> None:
    """Shapes, dtypes and one device for the five inputs."""
    if order.dim() != 2 or pred.dim() != 3 or times.dim() != 3:
        raise ValueError(f"expected order (B, n), pred (B, n, P), times "
                         f"(B, S, n); got {tuple(order.shape)}, "
                         f"{tuple(pred.shape)}, {tuple(times.shape)}")
    B, n = order.shape
    if (pred.shape[:2] != (B, n) or pred_delay.shape != pred.shape
            or floor.shape != (B, n) or times.shape[0] != B
            or times.shape[2] != n):
        raise ValueError(
            f"shapes do not align: order {tuple(order.shape)}, pred "
            f"{tuple(pred.shape)}, pred_delay {tuple(pred_delay.shape)}, "
            f"floor {tuple(floor.shape)}, times {tuple(times.shape)}")
    for name, t, dtype in (("order", order, torch.int32),
                           ("pred", pred, torch.int32),
                           ("pred_delay", pred_delay, torch.float32),
                           ("floor", floor, torch.float32),
                           ("times", times, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the replay takes {dtype}")
        if t.device != order.device:
            raise ValueError(f"{name} is on {t.device} and order on "
                             f"{order.device}")


def check_indices(order: torch.Tensor, pred: torch.Tensor) -> None:
    """Raise unless every order entry and pred slot indexes a task of its
    plan and every pred row is filled from the left (the kernel stops at a
    row's first -1)."""
    n = order.shape[1]
    bad = (((order < 0) | (order >= n)).any() | (pred < -1).any()
           | (pred >= n).any()
           | ((pred[..., 1:] >= 0) & (pred[..., :-1] < 0)).any())
    if bool(bad):
        raise ValueError("order or pred out of range, or a pred row with a "
                         "real slot after a -1")


def launch(order, pred, pred_delay, floor, times) -> torch.Tensor:
    """Launch the kernel on contiguous tensors on one card; returns (B, S)
    float32.  Raises on anything of the layout the kernel does not take:
    another device, a non-contiguous tensor, a grid too large, or a failed
    launch (an empty plan among them).  The indices are the caller's to check
    (:func:`check_indices`)."""
    global _launches
    check_inputs(order, pred, pred_delay, floor, times)
    for name, t in (("order", order), ("pred", pred),
                    ("pred_delay", pred_delay), ("floor", floor),
                    ("times", times)):
        if t.device.type != "cuda":
            raise ValueError(
                f"{name} is on {t.device}; the kernel needs the card")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, n, P = pred.shape
    S = times.shape[1]
    if B * -(-S // LANES) > _MAX_BLOCKS:
        raise ValueError(f"{B} plans x {S} seeds exceed the launch grid")
    out = torch.empty((B, S), dtype=torch.float32, device=order.device)
    if out.numel() == 0:
        return out
    finish = torch.empty((B, n, S), dtype=torch.float32, device=order.device)
    with torch.cuda.device(order.device):
        stream = torch.cuda.current_stream(order.device).cuda_stream
        err = _kernel()(order.data_ptr(), pred.data_ptr(),
                        pred_delay.data_ptr(), floor.data_ptr(),
                        times.data_ptr(), finish.data_ptr(), out.data_ptr(),
                        B, n, P, S, stream)
    if err != 0:
        raise RuntimeError(
            f"replay_makespans_f32 launch failed: CUDA error {err}")
    _launches += 1
    return out


def bucket_makespans(order, pred, pred_delay, floor, times) -> torch.Tensor:
    """(B, S) float32 makespans of the bucket: the plain version for CPU
    tensors, the kernel for tensors on the card."""
    check_inputs(order, pred, pred_delay, floor, times)
    if order.device.type == "cpu":
        return bucket_makespans_ref(order, pred, pred_delay, floor, times)
    check_indices(order, pred)
    return launch(order, pred, pred_delay, floor, times)
