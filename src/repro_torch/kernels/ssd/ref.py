"""The plain versions of the chunked SSD scan, its backward and the decode
step.

The function is the reference's Mamba-2 recurrence,
``repro.models.layers.ssm_apply``'s ``chunk_step`` under its ``lax.scan``
(``src/repro/models/layers.py:404-430``), its ``jax.grad``, and
``ssm_decode``'s state update and readout (``:474-478``):

* :func:`scan_ref`: dt (b, s, nh) fp32, xh (b, s, nh, hd), B and C (b, s,
  ns) in the compute dtype, A (nh,) fp32, chunks of ``lc`` steps -> (y
  (b, s, nh, hd), the final state (b, nh, hd, ns), the state entering each
  chunk (nc, b, nh, hd, ns)), all in the compute dtype.  Within a chunk the
  recurrence is decay-masked products, across chunks a loop carries the
  state.  Every product sums in fp32 and rounds once to the compute dtype;
  the decay, the masked scores and ``sdecay`` are fp32, rounded where they
  meet a product; the state update rounds ``state · exp(seg)``, the
  chunk's contribution and their sum.
* :func:`scan_grad_ref`: the recurrence's VJP written out as a reverse loop
  over chunks.  It carries fp32 throughout: the forward's values are taken
  as the forward rounded them (each product's partial derivative is its
  other operand as the forward used it), each rounding passes its
  cotangent straight through, and each cotangent is rounded once to its
  input's dtype at the end (dxh, dB, dC to the compute dtype; ddt and dA
  stay fp32).  The state cotangent entering the last chunk is the final
  state's (None: zeros).  The masked scores (j > i) take no part: the
  reference's ``jax.grad`` multiplies their zero cotangent by
  ``exp(cums_i - cums_j)``, which overflows above the diagonal at its
  default chunk of 256 and makes the gradients of B, C, dt and A NaN
  (ROADMAP C8); here the decay is masked before the exp.
* :func:`step_ref`: one decode step in place: ``state ← state · exp(dt·A) +
  (xh · dt) ⊗ B``, each product and the add rounded to the compute dtype,
  the conv window shifted, and y = Σ_n C_n · state_n (fp32 sums, rounded
  once).

:class:`Scan` is the scan with its backward as a ``torch.autograd.Function``
over a table of implementations; the saved per-chunk states go through
``save_for_backward``, so under remat they come from the recompute.
:func:`scan` takes the plain ones on any device.  The CPU and the tests use
these; a tensor on the card takes the kernel (``ssd.py``).
"""
from __future__ import annotations

import types

import torch


def scan_ref(dt: torch.Tensor, xh: torch.Tensor, Bmat: torch.Tensor,
             Cmat: torch.Tensor, A: torch.Tensor, lc: int):
    """The SSD recurrence over chunks of ``lc`` steps (the port's
    ``_chunk_scan`` of the served path, unchanged, with the state entering
    each chunk kept) -> (y, final state, states (nc, b, nh, hd, ns))."""
    cdt = xh.dtype
    b, s, nh, hd = xh.shape
    mask = torch.tril(torch.ones((lc, lc), dtype=torch.bool, device=xh.device))
    state = torch.zeros((b, nh, hd, Bmat.shape[-1]), dtype=cdt,
                        device=xh.device)
    ys, states = [], []
    for c0 in range(0, s, lc):
        states.append(state)
        dtc, xc = dt[:, c0:c0 + lc], xh[:, c0:c0 + lc]
        Bc, Cc = Bmat[:, c0:c0 + lc], Cmat[:, c0:c0 + lc]
        cums = torch.cumsum(dtc * A, dim=1)                       # (b, lc, nh)
        seg = cums[:, -1, :]                                      # (b, nh)
        # intra-chunk: y[i] += C_i·B_j · exp(cums_i - cums_j) · dt_j x_j
        decay = torch.exp(cums[:, :, None, :] - cums[:, None, :, :])
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)
        att = cb[..., None] * decay * dtc[:, None, :, :]
        att = torch.where(mask[None, :, :, None], att, 0.0)
        y = torch.einsum("bijh,bjhp->bihp", att.to(cdt), xc)
        # inter-chunk: y[i] += exp(cums_i) · C_i · S_prev
        y = y + (torch.einsum("bin,bhpn->bihp", Cc, state)
                 * torch.exp(cums).to(cdt)[..., None])
        # S <- exp(seg)·S + Σ_j exp(seg - cums_j) dt_j B_j ⊗ x_j
        sdecay = (torch.exp(seg[:, None, :] - cums) * dtc).to(cdt)
        contrib = torch.einsum("bjn,bjhp->bhpn", Bc,
                               sdecay[..., None] * xc)
        state = state * torch.exp(seg)[:, :, None, None].to(cdt) + contrib
        ys.append(y)
    y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
    return y, state, torch.stack(states)


def scan_grad_ref(dt: torch.Tensor, xh: torch.Tensor, Bmat: torch.Tensor,
                  Cmat: torch.Tensor, A: torch.Tensor, lc: int,
                  states: torch.Tensor, dy: torch.Tensor,
                  dfinal: torch.Tensor | None = None):
    """The VJP of :func:`scan_ref` at (dt, xh, B, C, A) for the cotangents
    dy (b, s, nh, hd) and ``dfinal`` (b, nh, hd, ns) or None, from the
    forward's ``states`` -> (dxh, ddt, dB, dC, dA) in the inputs' dtypes."""
    cdt, f32 = xh.dtype, torch.float32
    b, s, nh, hd = xh.shape
    ns = Bmat.shape[-1]
    dev = xh.device

    def r(t):                       # the forward's rounding, back in fp32
        return t.to(cdt).float()

    mask = torch.tril(torch.ones((lc, lc), dtype=torch.bool, device=dev))
    g = (torch.zeros((b, nh, hd, ns), dtype=f32, device=dev)
         if dfinal is None else dfinal.float())
    dxh = torch.empty((b, s, nh, hd), dtype=f32, device=dev)
    ddt = torch.empty((b, s, nh), dtype=f32, device=dev)
    dB = torch.empty((b, s, ns), dtype=f32, device=dev)
    dC = torch.empty((b, s, ns), dtype=f32, device=dev)
    dA = torch.zeros((nh,), dtype=f32, device=dev)
    for c in reversed(range(s // lc)):
        sl = slice(c * lc, (c + 1) * lc)
        dtc = dt[:, sl].float()
        xc, Bc, Cc = xh[:, sl].float(), Bmat[:, sl].float(), Cmat[:, sl].float()
        dyc, S = dy[:, sl].float(), states[c].float()
        # the forward's values, as it rounded them
        cums = torch.cumsum(dtc * A, dim=1)                      # (b, lc, nh)
        seg = cums[:, -1, :]
        # exp(cums_i - cums_j) where j <= i, 1 above the diagonal: there the
        # exponent is positive and grows with lc (exp overflows to inf at lc
        # 256), and the masked score's cotangent 0 times inf would be NaN
        decay = torch.exp(torch.where(mask[None, :, :, None],
                                      cums[:, :, None, :] - cums[:, None, :, :],
                                      0.0))
        cb = r(torch.einsum("bin,bjn->bij", Cc, Bc))
        L = torch.where(mask[None, :, :, None],
                        cb[..., None] * decay * dtc[:, None, :, :], 0.0)
        E = torch.exp(cums)
        Q = r(torch.einsum("bin,bhpn->bihp", Cc, S))
        sdv = torch.exp(seg[:, None, :] - cums) * dtc
        sd = r(sdv)
        U = r(sd[..., None] * xc)
        G = torch.exp(seg)
        # the state update: S' = r(r(S·G) + r(Σ_j B_j ⊗ U_j))
        dG = (g * S).sum((2, 3))                                 # (b, nh)
        dU = torch.einsum("bjn,bhpn->bjhp", Bc, g)
        dBc = torch.einsum("bjhp,bhpn->bjn", U, g)
        dX = sd[..., None] * dU
        dsd = (xc * dU).sum(-1)                                  # (b, lc, nh)
        # the inter-chunk output: y += r(Q · r(E))
        dQ = dyc * r(E)[..., None]
        dE = (dyc * Q).sum(-1)
        dCc = torch.einsum("bihp,bhpn->bin", dQ, S)
        g_prev = g * r(G)[:, :, None, None] + torch.einsum(
            "bihp,bin->bhpn", dQ, Cc)
        # the intra-chunk output: y += r(r(L) · x)
        dL = torch.einsum("bihp,bjhp->bijh", dyc, xc)
        dL = torch.where(mask[None, :, :, None], dL, 0.0)
        dX = dX + torch.einsum("bijh,bihp->bjhp", r(L), dyc)
        dcb = (dL * decay * dtc[:, None, :, :]).sum(-1)           # (b, i, j)
        ddt_c = (dL * cb[..., None] * decay).sum(1)              # (b, j, nh)
        dDelta = dL * L
        dcums = dDelta.sum(2) - dDelta.sum(1)
        dCc = dCc + torch.einsum("bij,bjn->bin", dcb, Bc)
        dBc = dBc + torch.einsum("bij,bin->bjn", dcb, Cc)
        # the decays' exponents: cums = cumsum(dt · A), seg = cums[-1]
        dcums = dcums + dE * E - dsd * sdv
        dcums[:, -1] += dG * G + (dsd * sdv).sum(1)
        da = torch.flip(torch.cumsum(torch.flip(dcums, [1]), 1), [1])
        ddt[:, sl] = ddt_c + dsd * torch.exp(seg[:, None, :] - cums) + da * A
        dA += (da * dtc).sum((0, 1))
        dxh[:, sl], dB[:, sl], dC[:, sl] = dX, dBc, dCc
        g = g_prev
    return dxh.to(cdt), ddt, dB.to(cdt), dC.to(cdt), dA


def step_ref(state: torch.Tensor, conv: torch.Tensor, window: torch.Tensor,
             xh: torch.Tensor, dtv: torch.Tensor, A: torch.Tensor,
             Bv: torch.Tensor, Cv: torch.Tensor) -> torch.Tensor:
    """One decode step: state (b, nh, hd, ns) and the conv window's last
    cw - 1 steps ``conv`` (b, cw-1, W) updated in place (``conv`` from the
    step's whole window (b, cw, W)); xh (b, nh, hd) and Bv, Cv (b, ns) in
    the compute dtype, dtv (b, nh) and A (nh,) fp32 -> y (b, nh, hd)."""
    cdt = state.dtype
    da = torch.exp(dtv * A)
    upd = (xh * dtv.to(cdt)[:, :, None])[..., None] * Bv[:, None, None, :]
    state.copy_(state * da[:, :, None, None].to(cdt) + upd)
    conv.copy_(window[:, 1:])
    return torch.einsum("bn,bhpn->bhp", Cv, state)


class Scan(torch.autograd.Function):
    """``ops.scan(dt, xh, B, C, A, lc)`` -> (y, final state); its backward
    ``ops.scan_grad`` from the per-chunk states the forward saved (with
    ``save_for_backward``, so remat's hooks see them).  A cotangent that
    does not flow comes as None (``set_materialize_grads(False)``)."""

    @staticmethod
    def forward(ctx, dt, xh, Bmat, Cmat, A, lc, ops):
        y, final, states = ops.scan(dt, xh, Bmat, Cmat, A, lc)
        ctx.lc, ctx.ops = lc, ops
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt, xh, Bmat, Cmat, A, states)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        dt, xh, Bmat, Cmat, A, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xh)
        grads = ctx.ops.scan_grad(dt, xh, Bmat, Cmat, A, ctx.lc, states, dy,
                                  dfinal)
        dxh, ddt, dB, dC, dA = (g if need else None for g, need in zip(
            grads, (ctx.needs_input_grad[1], ctx.needs_input_grad[0],
                    ctx.needs_input_grad[2], ctx.needs_input_grad[3],
                    ctx.needs_input_grad[4])))
        return ddt, dxh, dB, dC, dA, None, None


#: the plain versions as :class:`Scan` takes them
PLAIN = types.SimpleNamespace(scan=scan_ref, scan_grad=scan_grad_ref)


def scan(dt, xh, Bmat, Cmat, A, lc):
    """:func:`scan_ref` with its plain backward, on any device -> (y,
    final state)."""
    return Scan.apply(dt, xh, Bmat, Cmat, A, lc, PLAIN)
