"""The plain versions of the MoE capacity dispatch and the ordered combine.

The function is the reference's ``repro.models.layers.moe_apply`` between
the router's ``top_k`` and the expert products, and after them, for one
dispatch group:

* :func:`route_ref`: the entries ``i = t·k + j`` (token t's j-th choice)
  taken in a stable order by expert; ``pos`` is an entry's place among its
  expert's entries, ``keep = pos < cap`` and ``slot = min(e·cap + pos,
  E·cap − 1)``.  A dropped entry of an expert other than the last points
  into the next experts' rows, as the reference's ``jnp.minimum`` does.
* :func:`dispatch_ref`: the (E·cap, D) buffer, each row the kept entry's
  token row or zeros.  A dropped entry adds ``x · 0`` to its slot in the
  reference, which changes a row only where the token's value is not
  finite: such a column becomes NaN.
* :func:`combine_ref`: each token's k terms ``ho[slot] · (gate · keep)``,
  the weight rounded to the compute dtype first, summed from +0 in
  ascending expert order, each product and each add rounded to the compute
  dtype.  That is the order in which the reference's scatter-add meets a
  token's entries (sorted by expert), and with bf16 the order decides the
  result.  A dropped entry is multiplied by 0, not skipped, so a non-finite
  value in its row reaches the output.

Plain torch, no scatter that adds with atomics: every index write goes to
distinct places.  The CPU and the tests use these; a tensor on the card
takes the kernel (``moe.py``).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass
class Routing:
    """The routing of N tokens' k choices into E experts of ``cap`` rows.

    ``top_e`` (N, k) int32 the experts; ``slot`` (N·k,) int32 each entry's
    row of the (E·cap, D) buffer; ``keep`` (N·k,) bool; ``rows`` (E·cap,)
    int32 the entry each row holds (−1: none); ``stats`` (E + 1,) int32 the
    entries routed to each expert, then the count of dropped entries;
    ``dropped`` (N·k,) int32 the dropped entries in entry order, then −1.
    An expert outside [0, E) drops its entry into the last row.
    ``may_drop`` False: the host knows no entry dropped (``moe.route``'s
    ``distinct``), so the dispatch has no dropped row to mark.
    ``scratch``: the kernel's (3,) int32 counters on the card, zeroed by
    the route and left at zero by each dispatch (None in the plain
    version)."""

    top_e: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    rows: torch.Tensor
    stats: torch.Tensor
    dropped: torch.Tensor
    num_experts: int
    cap: int
    may_drop: bool = True
    scratch: torch.Tensor | None = None

    @property
    def top_k(self) -> int:
        return self.top_e.shape[1]


def capacity(n: int, k: int, e: int, capacity_factor: float) -> int:
    """Rows per expert for n tokens in one dispatch group, as the
    reference: ``min(max(ceil(n·k/E·cf/8)·8, 8), n)``."""
    cap = max(int(math.ceil(n * k / e * capacity_factor / 8.0)) * 8, 8)
    return min(cap, n)


def route_ref(top_e: torch.Tensor, num_experts: int, cap: int,
              may_drop: bool = True) -> Routing:
    """The plain routing of ``top_e`` (N, k) int32."""
    dev = top_e.device
    n, k = top_e.shape
    e, nk = num_experts, n * k
    flat = top_e.reshape(-1).long()
    ok = (flat >= 0) & (flat < e)
    key = torch.where(ok, flat, e)                  # out of range: last
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=e + 1)
    first = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(nk, device=dev)
    pos = torch.empty(nk, dtype=torch.long, device=dev)
    pos[order] = ranks - first[key[order]]
    keep = ok & (pos < cap)
    slot = torch.where(ok, torch.clamp_max(key * cap + pos, e * cap - 1),
                       e * cap - 1)
    rows = torch.full((e * cap,), -1, dtype=torch.int32, device=dev)
    rows[slot[keep]] = ranks[keep].int()
    drop = torch.nonzero(~keep)[:, 0].int()
    dropped = torch.full((nk,), -1, dtype=torch.int32, device=dev)
    dropped[:drop.numel()] = drop
    stats = torch.cat([counts[:e], (nk - keep.sum()).reshape(1)]).int()
    return Routing(top_e, slot.int(), keep, rows, stats, dropped, e, cap,
                   may_drop)


def dispatch_ref(x: torch.Tensor, r: Routing) -> torch.Tensor:
    """x (N, D) -> the (E·cap, D) expert buffer in x's dtype."""
    buf = torch.zeros((r.rows.numel(), x.shape[1]), dtype=x.dtype,
                      device=x.device)
    full = torch.nonzero(r.rows >= 0)[:, 0]
    buf[full] = x[r.rows[full].long() // r.top_k]
    drop = r.dropped[r.dropped >= 0].long()
    if drop.numel():
        bad, col = torch.nonzero(~torch.isfinite(x[drop // r.top_k]),
                                 as_tuple=True)
        buf[r.slot[drop[bad]].long(), col] = float("nan")    # x · 0 added
    return buf


def combine_ref(ho: torch.Tensor, r: Routing, gates: torch.Tensor
                ) -> torch.Tensor:
    """ho (E·cap, D) the experts' outputs, gates (N, k) float32 -> (N, D)
    in ho's dtype: each token's terms added in ascending expert order."""
    n, k = r.top_e.shape
    order = torch.sort(r.top_e, dim=1, stable=True).indices
    slot = r.slot.view(n, k).gather(1, order).long()
    keep = r.keep.view(n, k).gather(1, order)
    w = (gates.float().gather(1, order) * keep).to(ho.dtype)
    acc = torch.zeros((n, ho.shape[1]), dtype=ho.dtype, device=ho.device)
    for j in range(k):
        acc = acc + ho[slot[:, j]] * w[:, j, None]
    return acc
