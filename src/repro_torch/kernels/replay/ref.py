"""The plain version of the makespan replay of a bucket of plan DAGs.

``bucket_makespans_ref`` is the function the CUDA kernel
(``csrc/replay.cu``) computes, written with torch operations in the JAX
package's order of operations (``repro.sim.batch._one_makespan``): for
each step i of every plan b's topological order, task ``j = order[b, i]``
starts at

    max(max(0, max_k finish[pred[b, j, k]] + pred_delay[b, j, k]), floor[b, j])

over its unmasked slots (``pred >= 0``) and finishes ``times[b, s, j]``
later; the makespan of lane (b, s) is the largest finish.  Every value is
float32 and every operation an add or a max, so each sum is rounded once
and the result equals the reference's float32 scan bit for bit.  The
(plan, seed) lanes are a batch; the steps are a Python loop.
"""
from __future__ import annotations

import torch


def bucket_makespans_ref(order: torch.Tensor, pred: torch.Tensor,
                         pred_delay: torch.Tensor, floor: torch.Tensor,
                         times: torch.Tensor) -> torch.Tensor:
    """order: (B, n_pad) int; pred: (B, n_pad, P_pad) int, -1 = none;
    pred_delay: (B, n_pad, P_pad) and floor: (B, n_pad) float32; times:
    (B, S, n_pad) float32.  Returns the (B, S) float32 makespans."""
    B, n_pad = order.shape
    S = times.shape[1]
    dev = order.device
    rows = torch.arange(B, device=dev)
    finish = torch.zeros((B, n_pad, S), dtype=torch.float32, device=dev)
    for i in range(n_pad):
        j = order[:, i].long()
        p = pred[rows, j].long()                                  # (B, P)
        pf = finish[rows[:, None], p.clamp(min=0)] \
            + pred_delay[rows, j][:, :, None]                     # (B, P, S)
        pf = torch.where((p >= 0)[:, :, None], pf, 0.0)
        start = torch.maximum(pf.amax(dim=1).clamp(min=0.0),
                              floor[rows, j][:, None])
        finish[rows, j] = start + times[rows, :, j]
    return finish.amax(dim=1)
