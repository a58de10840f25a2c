"""A numpy emulation of the first-order LP kernel's gradient.

``csrc/hlp_fo.cu`` computes the loss's gradient with a hand-written reverse
scan over the topological levels; the plain version
(``repro_torch/kernels/hlp_fo/ref.py``) takes it from autograd.  This module
follows the kernel's scans task by task in float32, in its order: the soft
forward (each task's finish f, max m and sum S over its pred slots), the
loss's cotangents (the smooth max of the soft critical path and the pool
loads), and the reverse pass, in which a task gathers its adjoint from its
successors' softmax weights (recomputed from their m and c), sets its own
coefficient c = g_soft τ / (S + 1e-30) and runs the chain rule into its
logits.  ``gradient`` returns the logits' gradient at one step, so the
tests can hold the kernel's design to autograd without a card.
"""
import numpy as np

f32 = np.float32
NEG = f32(-1e30)
TINY = f32(1e-30)


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _sigmoid(z):
    with np.errstate(over="ignore"):
        return f32(1) / (f32(1) + np.exp(-z))


def _softmax_row(z):
    e = np.exp(z - z.max())
    return (e / e.sum(dtype=f32)).astype(f32)


def gradient(d, z, tau, *, m=None, k=None, p_choice=None, area=None,
             type_mask=None, inv_counts=None, use_comm=False):
    """The kernel's gradient of the loss at logits ``z`` and temperature
    ``tau``: the hybrid solve's ((n,) logits, ``m`` and ``k``) or, given
    ``p_choice``, the choice solve's ((n, C) logits).  ``d`` is a
    ``PaddedDag``; everything is float32."""
    pred, level_ptr = _np(d.pred), _np(d.level_ptr)
    level_task, succ_ptr = _np(d.level_task), _np(d.succ_ptr)
    succ_task, succ_slot = _np(d.succ_task), _np(d.succ_slot)
    comm = _np(d.pred_comm).astype(f32)
    z = _np(z).astype(f32)
    tau = f32(tau)
    n = pred.shape[0]
    choice = p_choice is not None
    levels = [level_task[a:b] for a, b in zip(level_ptr[:-1], level_ptr[1:])]
    if choice:
        pch, ar = _np(p_choice).astype(f32), _np(area).astype(f32)
        tm, inv = _np(type_mask).astype(f32), _np(inv_counts).astype(f32)
        x = np.stack([_softmax_row(r) for r in z])
        X = (x @ tm.T).astype(f32)
        times = np.array([sum((f32(pch[j, c] * x[j, c])
                               for c in range(1, x.shape[1])),
                              f32(pch[j, 0] * x[j, 0])) for j in range(n)],
                         dtype=f32)
    else:
        pc, pg = _np(d.pc).astype(f32), _np(d.pg).astype(f32)
        x = _sigmoid(z)
        times = (pc * x + pg * (f32(1) - x)).astype(f32)

    def slot_finish(f, j, kk, q):
        pf = f[q]
        if use_comm:
            pf = f32(pf + f32(comm[j, kk] * f32(f32(1) - f32(X[q] @ X[j]))))
        return pf

    def slots(j):
        return [(kk, int(q)) for kk, q in enumerate(pred[j]) if q >= 0]

    # the soft forward
    f = np.zeros(n, dtype=f32)
    mv = np.full(n, NEG, dtype=f32)
    sc = np.zeros(n, dtype=f32)
    for tasks in levels:
        for j in tasks:
            start = f32(0)
            if pred[j, 0] >= 0:
                pfs = [slot_finish(f, j, kk, q) for kk, q in slots(j)]
                mv[j] = max(pfs)
                sc[j] = sum((np.exp(f32((pf - mv[j]) / tau)) for pf in pfs),
                            f32(0))
                soft = f32(mv[j] + f32(tau * np.log(f32(sc[j] + TINY))))
                start = max(soft, f32(0))
            f[j] = f32(start + times[j])
    # the loss's cotangents
    M = f.max()
    sum_f = np.exp(((f - M) / tau).astype(f32)).sum(dtype=f32)
    if choice:
        per_choice = (ar * x).sum(axis=0, dtype=f32)
        loads = ((tm @ per_choice) * inv).astype(f32)
    else:
        loads = np.array([f32(pc @ x) / f32(m),
                          f32(pg @ (f32(1) - x)) / f32(k)], dtype=f32)
    terms = np.concatenate([[f32(M + f32(tau * np.log(f32(sum_f + TINY))))],
                            loads]).astype(f32)
    e = np.exp(((terms - terms.max()) / tau).astype(f32))
    w = f32(tau / e.sum(dtype=f32))
    g_terms = ((w * e).astype(f32) / tau).astype(f32)
    cfin = f32(f32(g_terms[0] * tau) / f32(sum_f + TINY))
    # the reverse pass
    gz = np.zeros_like(z)
    for tasks in reversed(levels):
        for j in tasks:
            gf = f32(f32(cfin * np.exp(f32((f[j] - M) / tau))) / tau)
            gX = np.zeros(X.shape[1] if use_comm else 0, dtype=f32)
            for e_ in range(succ_ptr[j], succ_ptr[j + 1]):
                s, kk = int(succ_task[e_]), int(succ_slot[e_])
                pf = slot_finish(f, s, kk, j)
                gp = f32(f32(sc[s] * np.exp(f32((pf - mv[s]) / tau))) / tau)
                gf = f32(gf + gp)
                if use_comm:
                    gX = (gX + f32(-gp * comm[s, kk]) * X[s]).astype(f32)
            cj = f32(0)
            if pred[j, 0] >= 0:
                soft = f32(mv[j] + f32(tau * np.log(f32(sc[j] + TINY))))
                gs = gf if soft > 0 else (f32(0.5) * gf if soft == 0
                                          else f32(0))
                cj = f32(f32(gs * tau) / f32(sc[j] + TINY))
                if use_comm:
                    for kk, q in slots(j):
                        pf = slot_finish(f, j, kk, q)
                        gp = f32(f32(cj * np.exp(f32((pf - mv[j]) / tau)))
                                 / tau)
                        gX = (gX + f32(-gp * comm[j, kk]) * X[q]).astype(f32)
            sc[j] = cj
            if choice:
                gpc = ((g_terms[1:] * inv) @ tm).astype(f32)
                gx = (gf * pch[j] + gpc * ar[j]).astype(f32)
                if use_comm:
                    gx = (gx + gX @ tm).astype(f32)
                dot = f32(x[j] @ gx)
                gz[j] = (x[j] * (gx - dot)).astype(f32)
            else:
                dc = f32(g_terms[1] / f32(m))
                dg = f32(g_terms[2] / f32(k))
                gx = f32(f32(gf * pc[j]) - f32(gf * pg[j]))
                gx = f32(f32(gx + f32(dc * pc[j])) - f32(dg * pg[j]))
                gz[j] = f32(gx * f32(x[j] * f32(f32(1) - x[j])))
    return gz
