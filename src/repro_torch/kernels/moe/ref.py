"""The plain versions of the MoE capacity dispatch and the ordered combine,
and of their backward.

The function is the reference's ``repro.models.layers.moe_apply`` between
the router's ``top_k`` and the expert products, and after them, for one
dispatch group, and its ``jax.grad``:

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

The backward, three cotangents, each in a fixed order:

* :func:`dispatch_grad_ref`, the dispatch's for x: each token's k slot
  rows of the buffer's cotangent times ``keep``, added from +0 in
  ascending expert order: :func:`combine_ref` with unit gates, which is the
  reference's bf16 VJP bit for bit.
* :func:`combine_grad_ref`, the combine's for the experts' outputs: at a
  kept entry's row ``+0 + dout[token] · w`` (``w`` the entry's weight in
  the combine), +0 at a row that holds no entry, and NaN where a dropped
  entry's slot meets a token whose ``dout`` is not finite (its ``dout · 0``
  added): the dispatch's structure, each row scaled by its weight.  The
  rows are ``+0 + p``, not a copy of ``p``: the reference's scatter-add
  into zeros turns -0 into +0.
* :func:`gate_grad_ref`, the combine's for the gates: ``+0 + keep ·
  Σ_d cdt(dout[token, d] · ho[slot, d])``, summed in the compute dtype in
  the order of the program XLA:CPU compiles for the reference's VJP
  (:func:`xla_row_sum`: windows of :data:`WINDOW` elements), which the
  kernel follows.  That is the reference's ``jax.vjp`` bit for bit, in
  bf16 and in fp32.

:class:`Dispatch` and :class:`Combine` are the two ops with their backward
as ``torch.autograd.Function`` classes over a table of implementations;
:func:`dispatch` and :func:`combine` take the plain ones on any device.

Plain torch, no scatter that adds with atomics: every index write goes to
distinct places.  The CPU and the tests use these; a tensor on the card
takes the kernel (``moe.py``).
"""
from __future__ import annotations

import dataclasses
import math
import types

import torch
import torch.nn.functional as F

#: the width of XLA:CPU's reduce-window in a row sum (:func:`xla_row_sum`)
WINDOW = 32


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
    return _to_rows(x, r, None)


def _to_rows(x: torch.Tensor, r: Routing, gates: torch.Tensor | None
             ) -> torch.Tensor:
    """Each kept entry's token row of ``x`` at its slot, zeros elsewhere,
    NaN where a dropped entry's slot meets a non-finite value of its
    token; with ``gates`` each kept row is ``+0 + x[token] · cdt(gate)``."""
    buf = torch.zeros((r.rows.numel(), x.shape[1]), dtype=x.dtype,
                      device=x.device)
    full = torch.nonzero(r.rows >= 0)[:, 0]
    ent = r.rows[full].long()
    src = x[ent // r.top_k]
    if gates is not None:
        w = gates.reshape(-1).float()[ent].to(x.dtype)    # kept: gate · 1
        src = buf[full] + src * w[:, None]
    buf[full] = src
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


def dispatch_grad_ref(dbuf: torch.Tensor, r: Routing) -> torch.Tensor:
    """The dispatch's cotangent for x: dbuf (E·cap, D) -> (N, D), each
    token's slot rows times ``keep`` added in ascending expert order."""
    n, k = r.top_e.shape
    return combine_ref(dbuf, r, torch.ones((n, k), device=dbuf.device))


def combine_grad_ref(dout: torch.Tensor, r: Routing, gates: torch.Tensor
                     ) -> torch.Tensor:
    """The combine's cotangent for the experts' outputs: dout (N, D),
    gates (N, k) -> (E·cap, D) in dout's dtype."""
    return _to_rows(dout, r, gates)


def xla_row_sum(v: torch.Tensor) -> torch.Tensor:
    """Each row of ``v`` (M, D) summed in its dtype, in the order XLA:CPU
    compiles a row sum whose reducer rounds to that dtype: while more than
    :data:`WINDOW` values remain, a reduce-window of :data:`WINDOW`, stride
    :data:`WINDOW`, padded with ``pad // 2`` zeros in front and the rest
    behind (``pad = -D mod WINDOW``), each window summed in order from +0,
    every add taken in fp32 and rounded to the dtype; then the values left
    summed in order from +0 the same way.  -> (M,) in ``v``'s dtype."""
    m = v.shape[0]
    while v.shape[1] > WINDOW:
        pad = -v.shape[1] % WINDOW
        w = F.pad(v, (pad // 2, pad - pad // 2)).view(m, -1, WINDOW)
        acc = torch.zeros(w.shape[:2], dtype=v.dtype, device=v.device)
        for j in range(WINDOW):
            acc = (acc.float() + w[:, :, j].float()).to(v.dtype)
        v = acc
    acc = torch.zeros(m, dtype=v.dtype, device=v.device)
    for j in range(v.shape[1]):
        acc = (acc.float() + v[:, j].float()).to(v.dtype)
    return acc


def gate_grad_ref(dout: torch.Tensor, ho: torch.Tensor, r: Routing
                  ) -> torch.Tensor:
    """The combine's cotangent for the gates: dout (N, D), ho (E·cap, D) in
    one dtype -> (N, k) float32.

    Each entry's products ``dout[token, d] · ho[slot, d]`` taken in fp32
    and rounded to the compute dtype, summed by :func:`xla_row_sum`, as
    XLA:CPU's program for the reference's VJP sums them; the sum in fp32
    times ``keep``, added to +0 (the transpose of the reference's
    ``take_along_axis`` of the gates is a scatter-add into zeros, which
    turns -0 into +0): a dropped entry gives +0, or NaN where its dot is
    not finite."""
    n, k = r.top_e.shape
    tok = torch.arange(n * k, device=dout.device) // k
    prod = (dout[tok].float() * ho[r.slot.long()].float()).to(dout.dtype)
    dot = xla_row_sum(prod).float()
    return (dot * r.keep.float() + 0.0).view(n, k)


class Dispatch(torch.autograd.Function):
    """``ops.dispatch(x, r)``, its backward ``ops.dispatch_grad``; the
    routing and the table pass through with no gradient."""

    @staticmethod
    def forward(ctx, x, r, ops):
        ctx.r, ctx.ops = r, ops
        return ops.dispatch(x, r)

    @staticmethod
    def backward(ctx, dbuf):
        return ctx.ops.dispatch_grad(dbuf, ctx.r), None, None


class Combine(torch.autograd.Function):
    """``ops.combine(ho, r, gates)``, its backward ``ops.combine_grad``
    (for ho) and ``ops.gate_grad`` (for the gates); ho and the gates are
    saved with ``save_for_backward``, so remat's hooks see them."""

    @staticmethod
    def forward(ctx, ho, r, gates, ops):
        ctx.r, ctx.ops = r, ops
        ctx.save_for_backward(ho, gates)
        return ops.combine(ho, r, gates)

    @staticmethod
    def backward(ctx, dout):
        ho, gates = ctx.saved_tensors
        ops, r = ctx.ops, ctx.r
        dho = (ops.combine_grad(dout, r, gates) if ctx.needs_input_grad[0]
               else None)
        dg = ops.gate_grad(dout, ho, r) if ctx.needs_input_grad[2] else None
        return dho, None, dg, None


#: the plain versions as :class:`Dispatch` and :class:`Combine` take them
PLAIN = types.SimpleNamespace(dispatch=dispatch_ref, combine=combine_ref,
                              dispatch_grad=dispatch_grad_ref,
                              combine_grad=combine_grad_ref,
                              gate_grad=gate_grad_ref)


def dispatch(x: torch.Tensor, r: Routing) -> torch.Tensor:
    """:func:`dispatch_ref` with its plain backward, on any device."""
    return Dispatch.apply(x, r, PLAIN)


def combine(ho: torch.Tensor, r: Routing, gates: torch.Tensor
            ) -> torch.Tensor:
    """:func:`combine_ref` with its plain backward, on any device."""
    return Combine.apply(ho, r, gates, PLAIN)
