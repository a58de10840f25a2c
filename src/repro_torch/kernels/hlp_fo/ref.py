"""The plain PyTorch version of the first-order LP's two solves.

The counterpart of the JAX package's jitted ``repro.core.hlp_jax._solve``
(the hybrid sigmoid solve, Q = 2, comm-free) and ``::_solve_choice`` (a
softmax over an (n, C) choice grid, optionally with the expected crossing
delay of every pred edge): ``iters`` Adam steps on logits against the
τ-annealed soft longest path, keeping the iterate of least exact λ.  Every
value is float32, as the reference runs with x64 off.

The scans walk the topological levels (``d.level_slices``) and work on a
whole level at once: a task depends only on the finish times of earlier
levels, so each task's arithmetic is the reference's, in its order.  The
hybrid solve's gradient is ``torch.autograd.grad`` of the loss, which makes
it an independent check of the kernel's hand-written backward
(``csrc/hlp_fo_sm90.cu``).  The choice solve's gradient and exact λ are
written out in the order of the program XLA:CPU compiles for the
reference's ``jax.grad(loss)`` and ``lam_exact`` (:func:`choice_grad`,
:func:`choice_lam`): every multiply-add XLA contracts is one rounding,
every sum runs in XLA's order, and the reverse scan scatters each task's
slot cotangents into its predecessors.  On an ill-conditioned instance
(netbound seed 300) autograd's rounding order alone moves λ 8x further
from the reference than the reference's own one-ulp spread; in XLA's order
it lies inside that spread.

``d`` is any object with the fields of ``repro_torch.core.hlp_jax.PaddedDag``
on the CPU.  The functions here take CPU tensors only.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["ADAM", "NEG", "choice_grad", "choice_lam", "choice_loss",
           "choice_solve_ref", "fma", "hard_longest_path", "hybrid_loss",
           "hybrid_solve_ref", "schedule", "soft_longest_path", "sqrt_rn",
           "window_sum"]

NEG = -1e30
#: Adam's constants as the reference writes them: Python floats, which
#: round to float32 where they meet a float32 tensor, as in JAX
ADAM = {"lr": 0.25, "b1": 0.9, "b2": 0.999, "eps": 1e-8,
        "one_b1": 1 - 0.9, "one_b2": 1 - 0.999}
LOG_8 = np.float32(np.log(1 / 8.0))       # jnp.log(1 / 8.0) in float32
LOG_512 = np.float32(np.log(1 / 512.0))


def _cpu(*tensors) -> None:
    for t in tensors:
        if t.device.type != "cpu":
            raise ValueError(f"the plain version takes CPU tensors; got one "
                             f"on {t.device}")


@functools.cache
def schedule(iters: int) -> torch.Tensor:
    """(iters, 3) float32: step i's anneal factor of τ (τ = scale · factor,
    from scale/8 down to scale/512 over the run, ``hlp_jax.py:148-149``)
    and Adam's bias corrections 1 - b1^(i+1) and 1 - b2^(i+1), each in the
    reference's float32 operations.  The kernel reads the same table."""
    f32 = torch.float32
    b1 = torch.tensor(ADAM["b1"], dtype=f32)
    b2 = torch.tensor(ADAM["b2"], dtype=f32)
    rows = []
    for i in range(iters):
        frac = torch.tensor(i, dtype=f32) / max(iters - 1, 1)
        factor = torch.exp(torch.tensor(LOG_8) * (1 - frac)
                           + torch.tensor(LOG_512) * frac)
        rows.append(torch.stack([factor, 1 - b1 ** (i + 1),
                                 1 - b2 ** (i + 1)]))
    return (torch.stack(rows) if rows
            else torch.zeros((0, 3), dtype=f32))


def soft_longest_path(d, times: torch.Tensor, tau: torch.Tensor,
                      edge_delay: torch.Tensor | None = None) -> torch.Tensor:
    """Temperature-τ softmax-relaxed longest path, level by level; τ → 0
    recovers the exact critical path.  ``edge_delay`` adds an (n, P) delay
    to each pred slot.  Differentiable."""
    zero = times.new_zeros(())
    finish = times.new_zeros(times.shape[0])
    for idx in d.level_slices:
        mask = d.pred_mask[idx]
        pf = finish[d.pred_long[idx]]          # a masked slot gathers row -1
        if edge_delay is not None:
            pf = pf + edge_delay[idx]
        pf = torch.where(mask, pf, NEG)
        m = pf.amax(dim=1)
        soft = m + tau * torch.log(
            torch.exp((pf - m[:, None]) / tau).sum(dim=1) + 1e-30) * 1.0
        start = torch.where(mask.any(dim=1), torch.maximum(soft, zero), zero)
        finish = finish.index_copy(0, idx, start + times[idx])
    m = finish.amax()
    return m + tau * torch.log(torch.exp((finish - m) / tau).sum() + 1e-30)


@torch.no_grad()
def hard_longest_path(d, times: torch.Tensor,
                      edge_delay: torch.Tensor | None = None) -> torch.Tensor:
    """The exact longest path under ``times`` (and pred-slot delays)."""
    finish = times.new_zeros(times.shape[0])
    for idx in d.level_slices:
        pf = finish[d.pred_long[idx]]
        if edge_delay is not None:
            pf = pf + edge_delay[idx]
        pf = torch.where(d.pred_mask[idx], pf, 0.0)
        finish[idx] = torch.clamp_min(pf.amax(dim=1), 0.0) + times[idx]
    return finish.amax()


# ----------------------------------------------------------------- hybrid
def _hybrid_terms(d, x, m: int, k: int):
    return (d.pc * x + d.pg * (1.0 - x), torch.dot(d.pc, x) / m,
            torch.dot(d.pg, 1.0 - x) / k)


def _smooth_max(terms: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    mx = terms.amax()
    return mx + tau * torch.log(torch.exp((terms - mx) / tau).sum())


def hybrid_loss(d, z: torch.Tensor, tau: torch.Tensor, m: int,
                k: int) -> torch.Tensor:
    """``_solve``'s loss: the smooth max of the soft critical path and the
    two loads, at x = σ(z)."""
    x = torch.sigmoid(z)
    times, load_c, load_g = _hybrid_terms(d, x, m, k)
    cp = soft_longest_path(d, times, tau)
    return _smooth_max(torch.stack([cp, load_c, load_g]), tau)


def _hybrid_lam(d, x, m: int, k: int) -> torch.Tensor:
    times, load_c, load_g = _hybrid_terms(d, x, m, k)
    return torch.maximum(hard_longest_path(d, times),
                         torch.maximum(load_c, load_g))


def _autograd(loss):
    """``(z, tau) -> d loss / d z`` by autograd."""
    def grad(z, tau):
        zg = z.detach().requires_grad_(True)
        gz, = torch.autograd.grad(loss(zg, tau), zg)
        return gz
    return grad


def _adam(z0: torch.Tensor, iters: int, scale: torch.Tensor, grad, mix, lam,
          sqrt=torch.sqrt):
    """Adam on logits from ``z0``, keeping the iterate of least exact λ."""
    a = ADAM
    z = z0.clone()
    mu = torch.zeros_like(z)
    nu = torch.zeros_like(z)
    with torch.no_grad():
        best_x = mix(z)
        best_val = lam(best_x)
    for i, (factor, bc1, bc2) in enumerate(schedule(iters)):
        tau = scale * factor
        gz = grad(z, tau)
        with torch.no_grad():
            mu = a["b1"] * mu + a["one_b1"] * gz
            nu = a["b2"] * nu + a["one_b2"] * gz * gz
            z = z - a["lr"] * (mu / bc1) / (sqrt(nu / bc2) + a["eps"])
            x = mix(z)
            val = lam(x)
            if val < best_val:
                best_x, best_val = x, val
    return best_x, best_val


def hybrid_solve_ref(d, z0: torch.Tensor, *, m: int, k: int,
                     iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``_solve`` from logits ``z0`` (n,): the best x (n,) float32 and its
    exact λ, a float32 scalar."""
    _cpu(d.pc, d.pg, z0)
    scale = torch.maximum(d.pc.max(), d.pg.max())
    return _adam(z0, iters, scale,
                 _autograd(lambda z, tau: hybrid_loss(d, z, tau, m, k)),
                 torch.sigmoid, lambda x: _hybrid_lam(d, x, m, k))


# ----------------------------------------------------------------- choice
def _seq_sum(cols) -> torch.Tensor:
    """((0 + c0) + c1) + ... in float32 over a sequence of tensors."""
    acc = None
    for c in cols:
        acc = 0.0 + c if acc is None else acc + c
    return acc


def _softmax(z: torch.Tensor, exp=torch.exp) -> torch.Tensor:
    """softmax over the choice axis, its sum taken left to right."""
    e = exp(z - z.amax(dim=1, keepdim=True).detach())
    return e / _seq_sum(e.unbind(1))[:, None]


def _choice_terms(d, x, p_choice, area, type_mask, inv_counts, use_comm):
    """The loss's terms as autograd takes them: task times, pool loads and
    (with ``use_comm``) each pred slot's expected crossing delay."""
    times = (p_choice * x).sum(dim=1)
    loads = (type_mask @ (area * x).sum(dim=0)) * inv_counts
    delay = None
    if use_comm:
        X = x @ type_mask.T                      # (n, Q) type marginals
        cross = 1.0 - torch.einsum("npq,nq->np", X[d.pred_long], X)
        delay = d.pred_comm * cross
    return times, loads, delay


def choice_loss(d, z, tau, p_choice, area, type_mask, inv_counts,
                use_comm: bool) -> torch.Tensor:
    """``_solve_choice``'s loss at x = softmax(z) over the choice axis,
    differentiable (autograd's order, not XLA's: :func:`choice_grad` is
    the solve's gradient)."""
    times, loads, delay = _choice_terms(d, _softmax(z), p_choice, area,
                                        type_mask, inv_counts, use_comm)
    cp = soft_longest_path(d, times, tau, delay)
    return _smooth_max(torch.cat([cp[None], loads]), tau)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The product of two float32 values is exact in float64 (24 + 24 bits);
    the float64 sum with ``c`` may round, and a second rounding to float32
    could then land on the wrong side of a float32 midpoint.  So the sum is
    rounded to odd first (an inexact float64 sum moves to the neighbour
    whose last bit is 1, found from TwoSum's exact error): a value rounded
    to odd at 53 bits rounds to 24 bits exactly as the exact value does
    (Boldo and Melquiond, 2008)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    up = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf)
                         .to(s.dtype))
    s = torch.where((err != 0) & even & torch.isfinite(s), up, s)
    return s.float()


def sqrt_rn(v: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded (as XLA's and the card's
    ``sqrtf`` are; ``torch.sqrt`` on the CPU's float32 is not always): taken
    in float64 and rounded to float32, which is exact, since 53 >= 2 * 24 + 2
    bits (Figueroa, 1995)."""
    return torch.sqrt(v.double()).float()


def window_sum(v: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 sum over the first axis of ``v``: windows of 32
    (the axis padded to a multiple of 32, the padding split between the
    two ends), each summed in order, then the windows' sums in order."""
    n = v.shape[0]
    lo = (-(-n // 32) * 32 - n) // 2
    return _seq_sum(_seq_sum(v[max(b, 0):b + 32].unbind(0))
                    for b in range(-lo, n, 32))


def _dot_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a[..., k] b[..., k] as XLA:CPU emits a dot: the first product
    rounded, each later one added by a fused multiply-add."""
    a, b = torch.broadcast_tensors(a, b)
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = fma(a[..., k], b[..., k], acc)
    return acc


def _csr_rows(d, edge: torch.Tensor):
    """Each task's successor slots (flat ``s * P + k``) in the order of the
    successor CSR in which ``edge`` (n, P) places each real slot, as an
    (n, width) int64 tensor (0 padded) and its mask."""
    real = d.pred_mask.reshape(-1)
    flat = torch.nonzero(real).reshape(-1)
    at = torch.empty_like(flat)
    at[edge.reshape(-1)[flat].long()] = flat
    ptr = d.succ_ptr.long()
    count = ptr[1:] - ptr[:-1]
    col = torch.arange(int(count.max()) if count.numel() else 0)
    ok = col[None, :] < count[:, None]
    place = (ptr[:-1, None] + col[None, :]).clamp_max(max(flat.numel() - 1,
                                                          0))
    return torch.where(ok, at[place], 0), ok


def _wrapped_pred(d) -> torch.Tensor:
    """``pred`` with a masked slot reading task n - 1, as XLA's gather
    wraps index -1."""
    pred = d.pred_long
    return torch.where(pred < 0, pred + pred.shape[0], pred)


class _Scan:
    """A DAG's index arrays for the choice entry's reverse scan: ``pred``
    with a masked slot reading task n - 1 (as XLA's gather wraps -1); each
    task's successor slots (flat ``s * P + k``) in descending order of the
    successor's place in ``d.topo`` (``d.pred_edge_topo``), the order in
    which the reference's reverse scan adds their cotangents to the task's;
    and in ascending order of successor id (``d.pred_edge``, the order of
    the marginals' scatter), with the successors."""

    def __init__(self, d):
        P = d.pred.shape[1]
        self.predw = _wrapped_pred(d)
        self.rev, self.rev_ok = _csr_rows(d, d.pred_edge_topo)
        self.fwd, self.fwd_ok = _csr_rows(d, d.pred_edge)
        self.fwd_task = self.fwd // P
        self.levels = list(d.level_slices)
        self.width = [int(self.rev_ok[idx].sum(1).max()) for idx in
                      self.levels]


def _xla_terms(d, x, p_choice, area, type_mask, inv_counts, use_comm):
    """The loss's terms in XLA's order: task times (a chain of fused
    multiply-adds), the per-choice area sums (:func:`window_sum`), the pool
    loads and, with ``use_comm``, the type marginals X and each pred slot's
    expected crossing delay."""
    times = torch.zeros(x.shape[0])
    for c in range(x.shape[1]):
        times = fma(p_choice[:, c], x[:, c], times)
    colsum = window_sum(area * x)
    loads = _dot_fma(type_mask, colsum[None, :]) * inv_counts
    X = delay = None
    if use_comm:
        X = _dot_fma(x[:, None, :], type_mask[None, :, :])          # (n, Q)
        delay = d.pred_comm * (1.0 - _dot_fma(X[_wrapped_pred(d)],
                                              X[:, None, :]))
    return times, colsum, loads, X, delay


def choice_lam(d, x, p_choice, area, type_mask, inv_counts,
               use_comm) -> torch.Tensor:
    """The exact λ of x in XLA's order: the longest path under the task
    times and crossing delays, or the largest pool load."""
    times, _, loads, _, delay = _xla_terms(d, x, p_choice, area, type_mask,
                                           inv_counts, use_comm)
    return torch.maximum(hard_longest_path(d, times, delay), loads.max())


def choice_grad(d, z, tau, p_choice, area, type_mask, inv_counts,
                use_comm: bool, *, exp=torch.exp, log=torch.log,
                scan: _Scan | None = None) -> torch.Tensor:
    """The gradient of ``_solve_choice``'s loss at logits ``z`` (n, C),
    written out in the order of the program XLA:CPU compiles for the
    reference's ``jax.grad(loss)``: the softmax and the forward's terms
    (:func:`_xla_terms`), the forward scan keeping each task's residuals,
    the smooth max's cotangents, the reverse scan (a task's cotangent is
    complete once its successors, later in ``d.topo``, have added theirs
    in that order; it then scatters its slots' cotangents, with the
    max's own, into its predecessors), then the transposes of the
    crossings, the marginals and the softmax.  The scans run a level at a
    time, which orders nothing: a task reads only earlier levels.
    ``exp`` and ``log`` stand in for the transcendentals (a test passes
    the reference's)."""
    o = scan or _Scan(d)
    f32 = torch.float32
    n, C = z.shape
    P = o.predw.shape[1]
    tau = torch.as_tensor(tau, dtype=f32)
    mask = d.pred_mask
    e = exp(z - z.amax(dim=1, keepdim=True))
    S = _seq_sum(e.unbind(1))
    inv_s2 = 1.0 / (S * S)
    x = e / S[:, None]
    times, colsum, loads, X, delay = _xla_terms(
        d, x, p_choice, area, type_mask, inv_counts, use_comm)
    # the forward scan and its residuals
    finish = torch.zeros(n)
    E, IND = torch.zeros((n, P)), torch.zeros((n, P))
    S1, cnt, tie = torch.zeros(n), torch.zeros(n), torch.zeros(n)
    has = mask.any(dim=1)
    for idx in o.levels:
        pf = finish[o.predw[idx]]
        if delay is not None:
            pf = pf + delay[idx]
        pf = torch.where(mask[idx], pf, NEG)
        m = pf.amax(dim=1)
        ee = exp((pf - m[:, None]) / tau)
        hit = pf == m[:, None]
        E[idx], IND[idx], cnt[idx] = ee, hit.to(f32), hit.sum(1).to(f32)
        s1 = _seq_sum(ee.unbind(1)) + 1e-30
        soft = fma(tau.expand_as(s1), log(s1), m)
        top = torch.clamp_min(soft, 0.0)
        S1[idx] = s1
        tie[idx] = torch.where(soft == top,
                               torch.where(top == 0, 0.5, 1.0), 0.0)
        finish[idx] = torch.where(has[idx], top, 0.0) + times[idx]
    # the smooth max of the critical path and the loads
    mfin = finish.amax()
    ef = exp((finish - mfin) / tau)
    at_max = finish == mfin
    Sf = window_sum(ef)
    cp = fma(tau, log(Sf + 1e-30), mfin)
    terms = torch.cat([cp[None], loads])
    mx = terms.amax()
    et = exp((terms - mx) / tau)
    gterm = (tau / _seq_sum(et.unbind(0)) * et) / tau
    gmx = (-_seq_sum(gterm.unbind(0)) + 1.0) / (terms == mx).sum().to(f32)
    gsel = gterm + torch.where(terms == mx, gmx, 0.0)
    gcp = gsel[0]
    gSf = (tau * gcp) / (Sf + 1e-30)
    gcolsum = _dot_fma(gsel[1:] * inv_counts, type_mask.T)          # (C,)
    gef = (gSf * ef) / tau
    gmfin = (gcp + -window_sum(gef)) / window_sum(at_max.to(f32))
    gfinish = gef + torch.where(at_max, gmfin, 0.0)
    # the reverse scan
    gtimes = torch.zeros(n)
    gpf_all = torch.zeros(n * P)
    for idx, w in zip(reversed(o.levels), reversed(o.width)):
        g = gfinish[idx]
        for k in range(w):
            g = torch.where(o.rev_ok[idx, k], g + gpf_all[o.rev[idx, k]], g)
        gsoft = torch.where(has[idx], g, 0.0) * tie[idx]
        gS = (tau * gsoft) / S1[idx]
        gtimes[idx] = 0.0 + g
        ge = (gS[:, None] * E[idx]) / tau
        gm = (gsoft + -_seq_sum(ge.unbind(1))) / cnt[idx]
        gpf = torch.where(mask[idx], fma(gm[:, None].expand_as(ge), IND[idx],
                                         ge), 0.0)
        gpf_all.view(n, P)[idx] = 0.0 + gpf
    # the transposes: the crossings into the marginals, then the softmax
    gx = fma(area, gcolsum.expand_as(area), p_choice * gtimes[:, None])
    if use_comm:
        gcross = -(d.pred_comm * gpf_all.view(n, P))
        gX = _dot_fma(X[o.predw].transpose(1, 2), gcross[:, None, :])
        flat = gcross.reshape(-1)
        for k in range(o.fwd.shape[1]):
            gX = torch.where(o.fwd_ok[:, k, None],
                             gX + flat[o.fwd[:, k], None] * X[o.fwd_task[:, k]],
                             gX)
        gx = gx + _dot_fma(gX[:, None, :], type_mask.T[None, :, :])
    t = torch.zeros(n)
    for c in range(C):
        t = fma(gx[:, c] * inv_s2, e[:, c], t)
    return (gx / S[:, None] + (-t)[:, None]) * e


def choice_solve_ref(d, z0: torch.Tensor, p_choice: torch.Tensor,
                     area: torch.Tensor, type_mask: torch.Tensor,
                     inv_counts: torch.Tensor, *, iters: int,
                     use_comm: bool, exp=torch.exp, log=torch.log
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_solve_choice`` from logits ``z0`` (n, C): the best x (n, C)
    float32 and its exact λ, the gradient and λ in XLA's order.  ``exp``
    and ``log`` stand in for the solve's transcendentals (the softmax's
    and the gradient's; the anneal schedule's are the table's)."""
    _cpu(p_choice, area, type_mask, inv_counts, z0, d.pred_comm)
    scale = torch.where(torch.isfinite(p_choice), p_choice, 0.0).max()
    scan = _Scan(d)
    args = (p_choice, area, type_mask, inv_counts, use_comm)
    return _adam(z0, iters, scale,
                 lambda z, tau: choice_grad(d, z, tau, *args, exp=exp,
                                            log=log, scan=scan),
                 lambda z: _softmax(z, exp), lambda x: choice_lam(d, x, *args),
                 sqrt=sqrt_rn)
