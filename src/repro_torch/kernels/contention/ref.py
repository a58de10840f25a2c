"""The plain versions of the contention fixpoint, in float64 torch.

The functions the CUDA kernel (``csrc/contention.cu``) computes, written
with torch operations in the JAX package's order of operations, with the
plan axis of its ``vmap`` written out as a leading batch dimension:

* :func:`maxmin_rates_ref` mirrors ``repro.sim.network._maxmin_rates_jax``:
  ``num_links`` rounds of masked progressive filling, with the numpy
  solver's guard (no flow froze: freeze everything);
* :func:`fluid_finishes_ref` mirrors ``repro.sim.network.fluid_finishes_jax``:
  ``3 T + 4`` event steps of the fixed-start max-min fluid solve;
* :func:`contended_durations_ref` mirrors
  ``repro.sim.batch._contended_durations``: ``iters`` rounds of a float64
  replay of each plan's augmented DAG, the fluid solve at the transfers'
  starts, and the per-plan freeze once the durations stop moving.

Every loop runs its fixed count, as the reference's ``fori_loop`` and
``scan`` do; every sum and product is its own operation, rounded once
(nothing is fused into a multiply-add).  The kernel equals these bit for
bit.
"""
from __future__ import annotations

import torch

_EPS = 1e-12
_F64 = torch.float64


def maxmin_rates_ref(active: torch.Tensor, up: torch.Tensor, dn: torch.Tensor,
                     capacity: torch.Tensor, num_links: int) -> torch.Tensor:
    """(B, T) max-min fair rates of the ``active`` (B, T) flows, each over
    its uplink ``up`` and downlink ``dn`` (B, T) of ``num_links`` links of
    capacity ``capacity`` (B,)."""
    B, T = active.shape
    up, dn = up.long(), dn.long()
    cap = capacity[:, None]
    rate = torch.zeros((B, T), dtype=_F64)
    used = torch.zeros((B, num_links), dtype=_F64)
    unfrozen = active.clone()
    for _ in range(num_links):
        w = unfrozen.to(_F64)
        n_l = (torch.zeros((B, num_links), dtype=_F64)
               .scatter_add(1, up, w).scatter_add(1, dn, w))
        some = n_l > 0
        headroom = torch.where(some, (cap - used)
                               / torch.where(some, n_l, 1.0), torch.inf)
        inc = headroom.amin(dim=1)
        inc = torch.where(torch.isfinite(inc), inc, 0.0).clamp(min=0.0)
        rate = rate + torch.where(unfrozen, inc[:, None], 0.0)
        used = used + inc[:, None] * n_l
        saturated = used >= cap - _EPS
        froze = unfrozen & (saturated.gather(1, up) | saturated.gather(1, dn))
        unfrozen = torch.where(froze.any(dim=1, keepdim=True),
                               unfrozen & ~froze, False)
    return rate


def fluid_finishes_ref(starts: torch.Tensor, sizes: torch.Tensor,
                       up: torch.Tensor, dn: torch.Tensor, mask: torch.Tensor,
                       capacity: torch.Tensor, num_links: int) -> torch.Tensor:
    """(B, T) fluid finish times of transfers with fixed ``starts`` (B, T):
    a step either admits the next start or drains the fastest active
    transfer, re-solving the rates at each; ``mask`` marks the real
    transfers (padding finishes at 0)."""
    B, T = starts.shape
    starts = starts.to(_F64)
    sizes = sizes.to(_F64)
    capacity = capacity.to(_F64)
    tiny = torch.finfo(_F64).tiny
    thresh = (_EPS * capacity + _EPS)[:, None]
    live = mask & (sizes > _EPS)
    fin = torch.where(mask, starts, 0.0)
    t = torch.where(mask, starts, torch.inf).amin(dim=1)
    remaining = torch.where(live, sizes, 0.0)
    finished = ~live
    for _ in range(3 * T + 4):
        tc = t[:, None]
        active = live & ~finished & (starts <= tc + _EPS)
        rate = maxmin_rates_ref(active, up, dn, capacity, num_links)
        t_done = torch.where(active, tc + remaining
                             / rate.clamp(min=tiny), torch.inf).amin(dim=1)
        t_next = torch.where(live & ~finished & (starts > tc + _EPS),
                             starts, torch.inf).amin(dim=1)
        t_ev = torch.minimum(t_done, t_next)
        ok = torch.isfinite(t_ev)
        t_new = torch.where(ok, torch.maximum(t_ev, t), t)
        dt = torch.where(ok, t_new - t, 0.0)
        remaining = torch.where(active, remaining - rate * dt[:, None],
                                remaining)
        done_now = active & ok[:, None] & (remaining <= thresh)
        fin = torch.where(done_now, t_new[:, None], fin)
        finished = finished | done_now
        t = t_new
    return fin


def replay_finish_ref(order: torch.Tensor, pred: torch.Tensor,
                      pred_mask: torch.Tensor, pd: torch.Tensor,
                      times: torch.Tensor) -> torch.Tensor:
    """(B, n_pad) float64 finish times of each plan's augmented DAG: for
    every step i, task ``j = order[b, i]`` starts at the max, from 0, over
    its masked slots of ``finish[pred] + pd`` and finishes ``times[b, j]``
    later.  No floor and no width: the contention rounds' noise-free
    replay."""
    B, n_pad = order.shape
    rows = torch.arange(B)
    finish = torch.zeros((B, n_pad), dtype=_F64)
    for i in range(n_pad):
        j = order[:, i].long()
        p = pred[rows, j].long()
        pf = torch.where(pred_mask[rows, j],
                         finish[rows[:, None], p.clamp(min=0)] + pd[rows, j],
                         0.0)
        start = pf.amax(dim=1).clamp(min=0.0)
        finish[rows, j] = start + times[rows, j]
    return finish


def contended_durations_ref(order, pred, pred_mask, pred_tid, times, src,
                            size, up, dn, t_mask, capacity, num_links: int,
                            iters: int) -> torch.Tensor:
    """(B, T_pad) float64 transfer durations at the replay/fluid fixpoint of
    a bucket of B plans (the fields of ``sim.batch.ContendedBucket``).

    Round 0 charges each transfer its lone duration ``size / capacity``;
    each of ``iters`` rounds replays the DAG under the current durations
    (a pred slot's delay is the duration of the transfer ``pred_tid``
    behind it), starts each transfer when its producer ``src`` finishes,
    solves the fluid sub-problem and takes ``finish - start``.  A plan
    whose durations all moved by at most ``1e-9 + 1e-3 |dur|`` keeps them
    from then on."""
    B, T = size.shape
    n_pad, P = pred.shape[1:]
    rows = torch.arange(B)[:, None]
    times = times.to(_F64)
    size = size.to(_F64)
    capacity = capacity.to(_F64)
    tid = pred_tid.long().reshape(B, n_pad * P)
    dur = torch.where(t_mask, size / capacity[:, None], 0.0)
    done = torch.zeros(B, dtype=torch.bool)
    for _ in range(iters):
        pd = torch.where(tid >= 0, dur[rows, tid.clamp(min=0)], 0.0)
        finish = replay_finish_ref(order, pred, pred_mask,
                                   pd.reshape(B, n_pad, P), times)
        starts = finish[rows, src.long()]
        fin = fluid_finishes_ref(starts, size, up, dn, t_mask, capacity,
                                 num_links)
        new = torch.where(t_mask, fin - starts, 0.0)
        close = (((new - dur).abs() <= 1e-9 + 1e-3 * dur.abs())
                 | ~t_mask).all(dim=1)
        dur = torch.where(done[:, None], dur, new)
        done = done | close
    return dur
