"""A numpy emulation of the first-order LP kernels' designs.

``csrc/hlp_fo.cu`` (the gather design) and ``csrc/hlp_fo_sm90.cu`` (its
redesign) compute the loss's gradient with a hand-written reverse scan over
the topological levels; the plain version (``repro_torch/kernels/hlp_fo/
ref.py``) takes it from autograd.  This module follows the kernels' scans
task by task in float32, in their order, and their block reductions in
their tree (each thread's strided partial, a butterfly within each warp,
then the warps in order, at ``threads_for(widest level)`` threads):

* the gather design: a soft forward (each task's finish f, max m and sum S
  over its pred slots), the loss's cotangents, and a reverse pass in which
  a task gathers its adjoint from its successors' softmax weights
  (recomputed from their m and c), sets its own coefficient
  c = g_soft τ / (S + 1e-30) and runs the chain rule into its logits; the
  exact λ from a hard forward of its own;
* the sm90 design: one fused walk that computes each task's hard finish
  beside its soft f, m and S, keeping each pred slot's weight
  exp((pf - m) / τ) in an edge buffer w, one merged reduction, and a
  reverse walk in which a task turns its own slots' weights into the
  adjoints gp = c w / τ in place and its predecessors sum the stored gp in
  the successor CSR's order; the chain rule and Adam after the walk.

``gradient`` (gather) and ``gradient_sm90`` return the logits' gradient at
one step; ``solve`` runs whole solves in either design.  The tests hold
the two designs to each other bit for bit and to autograd at rtol 1e-5,
without a card.
"""
import numpy as np

f32 = np.float32
NEG = f32(-1e30)
TINY = f32(1e-30)
ADAM = (f32(0.25), f32(0.9), f32(0.999), f32(1e-8), f32(1 - 0.9),
        f32(1 - 0.999))


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def threads_for(width):
    return min(512, max(32, -(-width // 32) * 32))


def _sigmoid(z):
    with np.errstate(over="ignore"):
        return (f32(1) / (f32(1) + np.exp(-z))).astype(f32)


def _softmax_row(z):
    e = np.exp((z - z.max()).astype(f32)).astype(f32)
    s = f32(0)
    for v in e:
        s = f32(s + v)
    return (e / s).astype(f32)


def _max(a, b):
    return a if a > b else b


def block_reduce(vals, nt, op, init):
    """The kernels' block reduction of ``vals`` (one per task, in task
    order) at ``nt`` threads: each thread's strided partial from ``init``,
    a butterfly within each warp, then the warps' partials in order."""
    lanes = [init] * nt
    for t in range(nt):
        acc = init
        for v in vals[t::nt]:
            acc = op(acc, v)
        lanes[t] = acc
    warps = []
    for w in range(nt // 32):
        x = lanes[32 * w:32 * w + 32]
        for o in (16, 8, 4, 2, 1):
            x = [op(x[i], x[i ^ o]) for i in range(32)]
        warps.append(x[0])
    out = warps[0]
    for v in warps[1:]:
        out = op(out, v)
    return out


def _add(a, b):
    return f32(a + b)


class Problem:
    """One problem's arrays, as the kernels read them.  ``d`` is a
    ``PaddedDag``; the hybrid solve takes ``m`` and ``k``, the choice
    solve ``p_choice``, ``area``, ``type_mask``, ``inv_counts`` and
    ``use_comm``; everything is float32."""

    def __init__(self, d, *, m=None, k=None, p_choice=None, area=None,
                 type_mask=None, inv_counts=None, use_comm=False):
        self.pred, lp = _np(d.pred), _np(d.level_ptr)
        lt = _np(d.level_task)
        self.levels = [lt[a:b] for a, b in zip(lp[:-1], lp[1:])]
        self.succ_ptr = _np(d.succ_ptr)
        self.succ_task, self.succ_slot = _np(d.succ_task), _np(d.succ_slot)
        self.comm = _np(d.pred_comm).astype(f32)
        self.n, self.P = self.pred.shape
        self.nt = threads_for(max(len(t) for t in self.levels))
        self.choice = p_choice is not None
        self.use_comm = use_comm
        if self.choice:
            self.pch, self.ar = (_np(p_choice).astype(f32),
                                 _np(area).astype(f32))
            self.tm = _np(type_mask).astype(f32)
            self.inv = _np(inv_counts).astype(f32)
            self.C, self.Q = self.pch.shape[1], self.tm.shape[0]
            self.scale = f32(np.where(np.isfinite(self.pch), self.pch,
                                      f32(0)).max())
        else:
            self.pc, self.pg = _np(d.pc).astype(f32), _np(d.pg).astype(f32)
            self.m, self.k = f32(m), f32(k)
            self.scale = f32(max(self.pc.max(), self.pg.max()))

    # ------------------------------------------------------------ pieces
    def mix(self, z):
        if self.choice:
            return np.stack([_softmax_row(r) for r in z])
        return _sigmoid(z)

    def marginals(self, x):
        if not (self.choice and self.use_comm):
            return None
        X = np.empty((self.n, self.Q), f32)
        for j in range(self.n):
            for q in range(self.Q):
                acc = f32(x[j, 0] * self.tm[q, 0])
                for c in range(1, self.C):
                    acc = f32(acc + f32(x[j, c] * self.tm[q, c]))
                X[j, q] = acc
        return X

    def times(self, x):
        if not self.choice:
            return ((self.pc * x).astype(f32)
                    + (self.pg * (f32(1) - x)).astype(f32)).astype(f32)
        t = (self.pch[:, 0] * x[:, 0]).astype(f32)
        for c in range(1, self.C):
            t = (t + (self.pch[:, c] * x[:, c]).astype(f32)).astype(f32)
        return t

    def delay(self, X, j, kk, q):
        dot = f32(X[q, 0] * X[j, 0])
        for t in range(1, self.Q):
            dot = f32(dot + f32(X[q, t] * X[j, t]))
        return f32(self.comm[j, kk] * f32(f32(1) - dot))

    def slots(self, j):
        return [(kk, int(q)) for kk, q in enumerate(self.pred[j]) if q >= 0]

    def slot_finish(self, f, X, j, kk, q):
        pf = f[q]
        if X is not None:
            pf = f32(pf + self.delay(X, j, kk, q))
        return pf

    def load_sums(self, x):
        """The reduced pool-load sums: (pc.x, pg.(1 - x)) or the per-choice
        area sums."""
        if self.choice:
            return [block_reduce(list((self.ar[:, c] * x[:, c]).astype(f32)),
                                 self.nt, _add, f32(0))
                    for c in range(self.C)]
        return [block_reduce(list((self.pc * x).astype(f32)), self.nt, _add,
                             f32(0)),
                block_reduce(list((self.pg * (f32(1) - x)).astype(f32)),
                             self.nt, _add, f32(0))]

    def pool_loads(self, sums):
        if not self.choice:
            return [f32(sums[0] / self.m), f32(sums[1] / self.k)]
        out = []
        for q in range(self.Q):
            acc = f32(self.tm[q, 0] * sums[0])
            for c in range(1, self.C):
                acc = f32(acc + f32(self.tm[q, c] * sums[c]))
            out.append(f32(acc * self.inv[q]))
        return out

    def lam(self, hard_max, sums):
        loads = self.pool_loads(sums)
        return _max(hard_max, max(loads))

    def cotangents(self, M, sum_f, sums, tau):
        """The loss's cotangents: the final soft max's coefficient and the
        loads' (dc, dg, or the per-choice gpc)."""
        terms = [f32(M + f32(tau * np.log(f32(sum_f + TINY))))]
        terms += self.pool_loads(sums)
        mx = max(terms)
        e = [np.exp(f32(f32(t - mx) / tau)) for t in terms]
        st = f32(0)
        for v in e:
            st = f32(st + v)
        w = f32(tau / st)
        cfin = f32(f32(f32(f32(w * e[0]) / tau) * tau) / f32(sum_f + TINY))
        if not self.choice:
            dc = f32(f32(f32(w * e[1]) / tau) / self.m)
            dg = f32(f32(f32(w * e[2]) / tau) / self.k)
            return cfin, (dc, dg)
        gpc = np.zeros(self.C, f32)
        for q in range(self.Q):
            gq = f32(f32(f32(w * e[1 + q]) / tau) * self.inv[q])
            for c in range(self.C):
                gpc[c] = f32(gpc[c] + f32(self.tm[q, c] * gq))
        return cfin, gpc

    def gX_gather(self, j, gp_succ, gp_own, X):
        """The type marginals' cotangent of task j from its successors'
        edge adjoints (CSR order), then its own slots'."""
        gX = np.zeros(self.Q, f32)
        for (s, kk), gp in zip(self.succ(j), gp_succ):
            gd = -f32(gp * self.comm[s, kk])
            for q in range(self.Q):
                gX[q] = f32(gX[q] + f32(gd * X[s, q]))
        for (kk, q), gp in zip(self.slots(j), gp_own):
            gd = -f32(gp * self.comm[j, kk])
            for t in range(self.Q):
                gX[t] = f32(gX[t] + f32(gd * X[q, t]))
        return gX

    def succ(self, j):
        return [(int(self.succ_task[e]), int(self.succ_slot[e]))
                for e in range(self.succ_ptr[j], self.succ_ptr[j + 1])]

    def chain(self, j, x, gf, grads, gX):
        """d loss / d z of task j from its adjoint g_f."""
        if not self.choice:
            dc, dg = grads
            gx = f32(f32(gf * self.pc[j]) - f32(gf * self.pg[j]))
            gx = f32(f32(gx + f32(dc * self.pc[j])) - f32(dg * self.pg[j]))
            return f32(gx * f32(x[j] * f32(f32(1) - x[j])))
        gx = np.empty(self.C, f32)
        dot = f32(0)
        for c in range(self.C):
            gc = f32(f32(gf * self.pch[j, c]) + f32(grads[c] * self.ar[j, c]))
            if gX is not None:
                for q in range(self.Q):
                    gc = f32(gc + f32(gX[q] * self.tm[q, c]))
            gx[c] = gc
            dot = f32(dot + f32(x[j, c] * gc))
        return (x[j] * (gx - dot).astype(f32)).astype(f32)

    # ------------------------------------------------------------ gather
    def soft_forward(self, x, X, tau):
        t = self.times(x)
        f = np.zeros(self.n, f32)
        mv = np.full(self.n, NEG, f32)
        sc = np.zeros(self.n, f32)
        for tasks in self.levels:
            for j in tasks:
                start = f32(0)
                if self.pred[j, 0] >= 0:
                    pfs = [self.slot_finish(f, X, j, kk, q)
                           for kk, q in self.slots(j)]
                    m = NEG
                    for pf in pfs:
                        m = _max(m, pf)
                    s = f32(0)
                    for pf in pfs:
                        s = f32(s + np.exp(f32(f32(pf - m) / tau)))
                    mv[j], sc[j] = m, s
                    soft = f32(m + f32(tau * np.log(f32(s + TINY))))
                    start = _max(soft, f32(0))
                f[j] = f32(start + t[j])
        return f, mv, sc

    def hard_forward(self, x, X):
        t = self.times(x)
        f = np.zeros(self.n, f32)
        for tasks in self.levels:
            for j in tasks:
                start = f32(0)
                for kk, q in self.slots(j):
                    start = _max(start, self.slot_finish(f, X, j, kk, q))
                f[j] = f32(start + t[j])
        return f

    def reverse_gather(self, x, X, f, mv, sc, M, cfin, grads, tau):
        gz = np.zeros_like(x)
        sc = sc.copy()
        for tasks in reversed(self.levels):
            for j in tasks:
                gf = f32(f32(cfin * np.exp(f32(f32(f[j] - M) / tau))) / tau)
                gp_succ = []
                for s, kk in self.succ(j):
                    pf = self.slot_finish(f, X, s, kk, j)
                    gp = f32(f32(sc[s] * np.exp(f32(f32(pf - mv[s]) / tau)))
                             / tau)
                    gf = f32(gf + gp)
                    gp_succ.append(gp)
                cj, gp_own = f32(0), []
                if self.pred[j, 0] >= 0:
                    soft = f32(mv[j] + f32(tau * np.log(f32(sc[j] + TINY))))
                    gs = gf if soft > 0 else (f32(0.5) * gf if soft == 0
                                              else f32(0))
                    cj = f32(f32(gs * tau) / f32(sc[j] + TINY))
                    if X is not None:
                        for kk, q in self.slots(j):
                            pf = self.slot_finish(f, X, j, kk, q)
                            gp_own.append(f32(f32(cj * np.exp(
                                f32(f32(pf - mv[j]) / tau))) / tau))
                sc[j] = cj
                gX = (self.gX_gather(j, gp_succ, gp_own, X)
                      if X is not None else None)
                gz[j] = self.chain(j, x, gf, grads, gX)
        return gz

    def step_gather(self, x, X, tau, sums):
        """The gather design's gradient at x from the exact pass's load
        sums."""
        f, mv, sc = self.soft_forward(x, X, tau)
        M = block_reduce(list(f), self.nt, _max, NEG)
        sum_f = block_reduce([np.exp(f32(f32(v - M) / tau)) for v in f],
                             self.nt, _add, f32(0))
        cfin, grads = self.cotangents(M, sum_f, sums, tau)
        return self.reverse_gather(x, X, f, mv, sc, M, cfin, grads, tau)

    # -------------------------------------------------------------- sm90
    def fused_forward(self, x, X, tau, soft):
        """One walk: every task's hard finish and, with ``soft``, its soft
        finish, soft start and S + 1e-30, and each slot's weight in w."""
        t = self.times(x)
        fh = np.zeros(self.n, f32)
        f = np.zeros(self.n, f32)
        sv = np.zeros(self.n, f32)
        st = np.zeros(self.n, f32)
        w = np.zeros((self.n, self.P), f32)
        for tasks in self.levels:
            for j in tasks:
                hard, m, s, start, soft_j = f32(0), NEG, f32(0), f32(0), f32(0)
                if self.pred[j, 0] >= 0:
                    for kk, q in self.slots(j):
                        d = self.delay(X, j, kk, q) if X is not None else None
                        hard = _max(hard, fh[q] if d is None
                                    else f32(fh[q] + d))
                        if soft:
                            pf = f[q] if d is None else f32(f[q] + d)
                            m = _max(m, pf)
                            w[j, kk] = pf
                    if soft:
                        for kk, _ in self.slots(j):
                            e = np.exp(f32(f32(w[j, kk] - m) / tau))
                            w[j, kk] = e
                            s = f32(s + e)
                        soft_j = f32(m + f32(tau * np.log(f32(s + TINY))))
                        start = _max(soft_j, f32(0))
                fh[j] = f32(hard + t[j])
                if soft:
                    f[j], sv[j], st[j] = f32(start + t[j]), soft_j, f32(s + TINY)
        return fh, f, sv, st, w

    def reverse_push(self, x, X, e, sv, st, w, cfin, grads, tau):
        """The reverse walk: each task's g_f from its successors' stored gp,
        then its own slots' gp = c w / tau in place; then the chain rule
        of every task."""
        w = w.copy()
        gfs = np.zeros(self.n, f32)
        for tasks in reversed(self.levels):
            for j in tasks:
                gf = f32(f32(cfin * e[j]) / tau)
                for s, kk in self.succ(j):
                    gf = f32(gf + w[s, kk])
                if self.pred[j, 0] >= 0:
                    soft = sv[j]
                    gs = gf if soft > 0 else (f32(0.5) * gf if soft == 0
                                              else f32(0))
                    cj = f32(f32(gs * tau) / st[j])
                    for kk, _ in self.slots(j):
                        w[j, kk] = f32(f32(cj * w[j, kk]) / tau)
                gfs[j] = gf
        gz = np.zeros_like(x)
        for j in range(self.n):
            gX = None
            if X is not None:
                gX = self.gX_gather(j, [w[s, kk] for s, kk in self.succ(j)],
                                    [w[j, kk] for kk, _ in self.slots(j)], X)
            gz[j] = self.chain(j, x, gfs[j], grads, gX)
        return gz

    def forward_sm90(self, x, X, tau, soft=True):
        """The fused walk and its merged reduction: (λ, load sums, the
        walk's arrays, M)."""
        fh, f, sv, st, w = self.fused_forward(x, X, tau, soft)
        sums = self.load_sums(x)
        lam = self.lam(block_reduce(list(fh), self.nt, _max, NEG), sums)
        M = block_reduce(list(f), self.nt, _max, NEG) if soft else None
        return lam, sums, (f, sv, st, w), M

    def step_sm90(self, x, X, tau, fwd, M, sums):
        f, sv, st, w = fwd
        e = np.array([np.exp(f32(f32(v - M) / tau)) for v in f], f32)
        sum_f = block_reduce(list(e), self.nt, _add, f32(0))
        cfin, grads = self.cotangents(M, sum_f, sums, tau)
        return self.reverse_push(x, X, e, sv, st, w, cfin, grads, tau)


def _problem(d, **kw):
    kw = {k: v for k, v in kw.items() if v is not None}
    return Problem(d, **kw)


def gradient(d, z, tau, *, m=None, k=None, p_choice=None, area=None,
             type_mask=None, inv_counts=None, use_comm=False):
    """The gather kernel's gradient of the loss at logits ``z`` and
    temperature ``tau``: the hybrid solve's ((n,) logits, ``m`` and ``k``)
    or, given ``p_choice``, the choice solve's ((n, C) logits)."""
    pr = _problem(d, m=m, k=k, p_choice=p_choice, area=area,
                  type_mask=type_mask, inv_counts=inv_counts,
                  use_comm=use_comm)
    x = pr.mix(_np(z).astype(f32))
    return pr.step_gather(x, pr.marginals(x), f32(tau), pr.load_sums(x))


def gradient_sm90(d, z, tau, **kw):
    """The sm90 kernel's gradient at ``z`` and ``tau``, as
    :func:`gradient`."""
    pr = _problem(d, **kw)
    x = pr.mix(_np(z).astype(f32))
    X = pr.marginals(x)
    _, sums, fwd, M = pr.forward_sm90(x, X, f32(tau))
    return pr.step_sm90(x, X, f32(tau), fwd, M, sums)


def _adam(z, mu, nu, gz, bc1, bc2):
    lr, b1, b2, eps, ob1, ob2 = ADAM
    mu = (b1 * mu + (ob1 * gz).astype(f32)).astype(f32)
    nu = (b2 * nu + ((ob2 * gz).astype(f32) * gz).astype(f32)).astype(f32)
    step = ((lr * (mu / bc1).astype(f32)).astype(f32)
            / (np.sqrt((nu / bc2).astype(f32)) + eps).astype(f32)).astype(f32)
    return (z - step).astype(f32), mu, nu


def solve(d, z0, iters, sched, *, design, **kw):
    """A whole solve in one design (``"gather"`` or ``"sm90"``) from
    logits ``z0`` over the schedule table ``sched`` ((iters, 3) float32):
    the best x, its λ and each step's gradient."""
    pr = _problem(d, **kw)
    sched = _np(sched).astype(f32)
    z = _np(z0).astype(f32).copy()
    mu, nu = np.zeros_like(z), np.zeros_like(z)
    x = pr.mix(z)
    X = pr.marginals(x)
    grads = []
    if design == "gather":
        sums = pr.load_sums(x)
        best = pr.lam(block_reduce(list(pr.hard_forward(x, X)), pr.nt, _max,
                                   NEG), sums)
        best_x = x
        for i in range(iters):
            tau = f32(pr.scale * sched[i, 0])
            gz = pr.step_gather(x, X, tau, sums)
            grads.append(gz)
            z, mu, nu = _adam(z, mu, nu, gz, sched[i, 1], sched[i, 2])
            x = pr.mix(z)
            X = pr.marginals(x)
            sums = pr.load_sums(x)
            lam = pr.lam(block_reduce(list(pr.hard_forward(x, X)), pr.nt,
                                      _max, NEG), sums)
            if lam < best:
                best, best_x = lam, x
        return best_x, best, grads
    for i in range(iters + 1):
        soft = i < iters
        tau = f32(pr.scale * sched[i, 0]) if soft else f32(0)
        lam, sums, fwd, M = pr.forward_sm90(x, X, tau, soft)
        if i == 0 or lam < best:
            best, best_x = lam, x
        if not soft:
            break
        gz = pr.step_sm90(x, X, tau, fwd, M, sums)
        grads.append(gz)
        z, mu, nu = _adam(z, mu, nu, gz, sched[i, 1], sched[i, 2])
        x = pr.mix(z)
        X = pr.marginals(x)
    return best_x, best, grads
