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
gradient is ``torch.autograd.grad`` of the loss, which makes this version
an independent check of the kernel's hand-written backward
(``csrc/hlp_fo_sm90.cu``).

``d`` is any object with the fields of ``repro_torch.core.hlp_jax.PaddedDag``
on the CPU.  The functions here take CPU tensors only.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["ADAM", "NEG", "choice_loss", "choice_solve_ref",
           "hard_longest_path", "hybrid_loss", "hybrid_solve_ref", "schedule",
           "soft_longest_path"]

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


def _adam(z0: torch.Tensor, iters: int, scale: torch.Tensor, loss, mix, lam):
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
        zg = z.detach().requires_grad_(True)
        gz, = torch.autograd.grad(loss(zg, tau), zg)
        with torch.no_grad():
            mu = a["b1"] * mu + a["one_b1"] * gz
            nu = a["b2"] * nu + a["one_b2"] * gz * gz
            z = z - a["lr"] * (mu / bc1) / (torch.sqrt(nu / bc2) + a["eps"])
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
                 lambda z, tau: hybrid_loss(d, z, tau, m, k),
                 torch.sigmoid, lambda x: _hybrid_lam(d, x, m, k))


# ----------------------------------------------------------------- choice
def _softmax(z: torch.Tensor) -> torch.Tensor:
    e = torch.exp(z - z.amax(dim=1, keepdim=True).detach())
    return e / e.sum(dim=1, keepdim=True)


def _choice_terms(d, x, p_choice, area, type_mask, inv_counts, use_comm):
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
    """``_solve_choice``'s loss at x = softmax(z) over the choice axis."""
    times, loads, delay = _choice_terms(d, _softmax(z), p_choice, area,
                                        type_mask, inv_counts, use_comm)
    cp = soft_longest_path(d, times, tau, delay)
    return _smooth_max(torch.cat([cp[None], loads]), tau)


def choice_solve_ref(d, z0: torch.Tensor, p_choice: torch.Tensor,
                     area: torch.Tensor, type_mask: torch.Tensor,
                     inv_counts: torch.Tensor, *, iters: int,
                     use_comm: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``_solve_choice`` from logits ``z0`` (n, C): the best x (n, C)
    float32 and its exact λ."""
    _cpu(p_choice, area, type_mask, inv_counts, z0, d.pred_comm)
    scale = torch.where(torch.isfinite(p_choice), p_choice, 0.0).max()

    def lam(x):
        times, loads, delay = _choice_terms(d, x, p_choice, area, type_mask,
                                            inv_counts, use_comm)
        return torch.maximum(hard_longest_path(d, times, delay), loads.max())

    return _adam(z0, iters, scale,
                 lambda z, tau: choice_loss(d, z, tau, p_choice, area,
                                            type_mask, inv_counts, use_comm),
                 _softmax, lam)
