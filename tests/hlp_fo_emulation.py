"""A numpy emulation of the first-order LP kernel's designs, and the
reference's backward in XLA's order.

``csrc/hlp_fo.cu`` (the gather design, since deleted; kept here as an
independent model of the hand-written backward) and ``csrc/hlp_fo_sm90.cu``
(its redesign, the kernel) compute the loss's gradient with a hand-written
reverse scan over the topological levels.  This module follows the
kernels' scans task by task in float32, in their order, and the hybrid
solve's block reductions in their tree (each thread's strided partial, a
butterfly within each warp, then the warps in order, at
``threads_for(widest level)`` threads):

* the gather design: a soft forward (each task's finish f, max m and sum S
  over its pred slots), the loss's cotangents, and a reverse pass in which
  a task gathers its adjoint from its successors' softmax weights
  (recomputed from their m and their stored coefficients), then runs the
  chain rule into its logits; the exact λ from a hard forward of its own;
* the sm90 design: one fused walk that computes each task's hard finish
  beside its soft f, m and S, keeping each pred slot's weight
  exp((pf - m) / τ) in an edge buffer w, one merged reduction, and a
  reverse walk in which a task turns its own slots' weights into their
  cotangents in place and its predecessors sum the stored values; the
  chain rule and Adam after the walk.

The sm90 design also runs the choice solve (x = softmax(z)), in the order
of the program XLA:CPU compiles for the reference's gradient, as the plain
version (``repro_torch/kernels/hlp_fo/ref.py::choice_grad``) does: every
multiply-add XLA contracts one rounding, sums over tasks in windows of 32
(``_window_sum``), the cotangents of each max, a task's successors'
cotangents in descending order of their place in ``d.topo``
(``d.pred_edge_topo``), and the transposes of the crossings, the
marginals and the softmax in XLA's order.
Given the same ``exp`` and ``log`` it is the plain version bit for bit.

``gradient`` (gather, hybrid) and ``gradient_sm90`` return the logits'
gradient at one step; ``solve`` runs whole solves in either design.
``choice_grad_xla_order`` is the reference's own gradient of
``_solve_choice``'s loss, written out scan step by scan step in the order
XLA:CPU compiles it (ROADMAP C6): an independent model of
``ref.choice_grad``, which runs a level at a time.
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
    ``use_comm``; everything is float32.

    The choice solve (the sm90 design's only) runs in the reference's
    order (the plain version's, ``ref.choice_grad``): fused multiply-adds
    where XLA contracts, sums over tasks in windows of 32, the max's own
    cotangents, each task's successors' cotangents in descending order of
    their place in ``d.topo`` (``d.pred_edge_topo``).  ``exp`` and
    ``log`` (float32 in and out) are its transcendentals; the hybrid
    solve uses numpy's."""

    def __init__(self, d, *, m=None, k=None, p_choice=None, area=None,
                 type_mask=None, inv_counts=None, use_comm=False,
                 exp=np.exp, log=np.log):
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
            self.exp = lambda v: f32(np.asarray(exp(np.asarray(v, f32)), f32))
            self.log = lambda v: f32(np.asarray(log(np.asarray(v, f32)), f32))
            at = {int(e): (int(s), int(k)) for (s, k), e in
                  np.ndenumerate(_np(d.pred_edge_topo)) if e >= 0}
            self.succ_rev = [[at[e] for e in range(self.succ_ptr[j],
                                                   self.succ_ptr[j + 1])]
                             for j in range(self.n)]
        else:
            self.pc, self.pg = _np(d.pc).astype(f32), _np(d.pg).astype(f32)
            self.m, self.k = f32(m), f32(k)
            self.scale = f32(max(self.pc.max(), self.pg.max()))

    # ------------------------------------------------------------ pieces
    def softmax_parts(self, z):
        """Each row's exp(z - max) and their sum, left to right."""
        e = np.array([[self.exp(f32(v - r.max())) for v in r] for r in z],
                     f32)
        S = np.array([_seq_sum(r) for r in e], f32)
        return e, S

    def mix(self, z):
        if self.choice:
            e, S = self.softmax_parts(z)
            return (e / S[:, None]).astype(f32)
        return _sigmoid(z)

    def marginals(self, x):
        if not (self.choice and self.use_comm):
            return None
        X = np.empty((self.n, self.Q), f32)
        for j in range(self.n):
            for q in range(self.Q):
                X[j, q] = _dot_fma(x[j], self.tm[q])
        return X

    def times(self, x):
        if not self.choice:
            return ((self.pc * x).astype(f32)
                    + (self.pg * (f32(1) - x)).astype(f32)).astype(f32)
        t = np.zeros(self.n, f32)
        for c in range(self.C):
            t = _fma(self.pch[:, c], x[:, c], t)
        return t

    def delay(self, X, j, kk, q):
        return f32(self.comm[j, kk] * f32(f32(1) - _dot_fma(X[q], X[j])))

    def slots(self, j):
        return [(kk, int(q)) for kk, q in enumerate(self.pred[j]) if q >= 0]

    def slot_finish(self, f, X, j, kk, q):
        pf = f[q]
        if X is not None:
            pf = f32(pf + self.delay(X, j, kk, q))
        return pf

    def soft_start(self, m, s, tau):
        """m + τ log(S + 1e-30): one rounding of the multiply-add in the
        choice solve (XLA contracts it), two in the hybrid's."""
        if self.choice:
            return _fma(tau, self.log(f32(s + TINY)), m)
        return f32(m + f32(tau * np.log(f32(s + TINY))))

    def load_sums(self, x):
        """The reduced pool-load sums: (pc.x, pg.(1 - x)) in the block
        tree, or the per-choice area sums in windows of 32."""
        if self.choice:
            return list(_window_sum((self.ar * x).astype(f32)))
        return [block_reduce(list((self.pc * x).astype(f32)), self.nt, _add,
                             f32(0)),
                block_reduce(list((self.pg * (f32(1) - x)).astype(f32)),
                             self.nt, _add, f32(0))]

    def pool_loads(self, sums):
        if not self.choice:
            return [f32(sums[0] / self.m), f32(sums[1] / self.k)]
        return [f32(_dot_fma(self.tm[q], np.asarray(sums, f32)) * self.inv[q])
                for q in range(self.Q)]

    def lam(self, hard_max, sums):
        loads = self.pool_loads(sums)
        return _max(hard_max, max(loads))

    def cotangents(self, M, sum_f, sums, tau):
        """The hybrid loss's cotangents: the final soft max's coefficient
        and the loads' (dc, dg)."""
        terms = [self.soft_start(M, sum_f, tau)]
        terms += self.pool_loads(sums)
        mx = max(terms)
        e = [np.exp(f32(f32(t - mx) / tau)) for t in terms]
        st = f32(0)
        for v in e:
            st = f32(st + v)
        w = f32(tau / st)
        cfin = f32(f32(f32(f32(w * e[0]) / tau) * tau) / f32(sum_f + TINY))
        dc = f32(f32(f32(w * e[1]) / tau) / self.m)
        dg = f32(f32(f32(w * e[2]) / tau) / self.k)
        return cfin, (dc, dg)

    def choice_cotangents(self, f, M, sums, tau):
        """The choice loss's cotangents in the reference's order: each
        task's finish cotangent (the final soft max's, with the max's own
        on the tasks at M) and the per-choice area sums'."""
        ef = np.array([self.exp(f32(f32(v - M) / tau)) for v in f], f32)
        at = f == M
        Sf = _window_sum(ef)
        cp = _fma(tau, self.log(f32(Sf + TINY)), M)
        terms = [cp] + self.pool_loads(sums)
        mx = max(terms)
        et = [self.exp(f32(f32(t - mx) / tau)) for t in terms]
        r = f32(tau / _seq_sum(et))
        gterm = [f32(f32(r * e) / tau) for e in et]
        gmx = f32(f32(f32(1) - _seq_sum(gterm))
                  / f32(sum(t == mx for t in terms)))
        gsel = [f32(g + (gmx if t == mx else f32(0)))
                for g, t in zip(gterm, terms)]
        gload = [f32(g * self.inv[q]) for q, g in enumerate(gsel[1:])]
        gSf = f32(f32(tau * gsel[0]) / f32(Sf + TINY))
        gcolsum = np.array([_dot_fma(np.asarray(gload, f32), self.tm[:, c])
                            for c in range(self.C)], f32)
        gef = (np.float32(gSf) * ef).astype(f32) / tau
        gef = gef.astype(f32)
        gmfin = f32(f32(gsel[0] - _window_sum(gef))
                    / _window_sum(at.astype(f32)))
        return (gef + np.where(at, gmfin, f32(0))).astype(f32), gcolsum

    def gX_xla(self, j, gdelay, X):
        """Task j's marginals' cotangent in the reference's order: its own
        slots' crossings as a dot (fused multiply-adds), then each
        successor's, in ascending order of successor id.  ``gdelay`` maps
        (task, slot) to the slot delay's cotangent."""
        own = self.slots(j)
        if not own:
            gX = np.full(self.Q, f32(-0.0), f32)
        else:
            gc = np.array([-f32(self.comm[j, kk] * gdelay[j, kk])
                           for kk, _ in own], f32)
            Xq = np.array([X[q] for _, q in own], f32)
            gX = np.array([_dot_fma(Xq[:, t], gc) for t in range(self.Q)], f32)
        for s, kk in self.succ(j):
            gc = -f32(self.comm[s, kk] * gdelay[s, kk])
            for t in range(self.Q):
                gX[t] = f32(gX[t] + f32(gc * X[s, t]))
        return gX

    def succ(self, j):
        return [(int(self.succ_task[e]), int(self.succ_slot[e]))
                for e in range(self.succ_ptr[j], self.succ_ptr[j + 1])]

    def chain(self, j, x, gf, grads, gX):
        """The hybrid solve's d loss / d z of task j from its adjoint g_f."""
        dc, dg = grads
        gx = f32(f32(gf * self.pc[j]) - f32(gf * self.pg[j]))
        gx = f32(f32(gx + f32(dc * self.pc[j])) - f32(dg * self.pg[j]))
        return f32(gx * f32(x[j] * f32(f32(1) - x[j])))

    def chain_xla(self, j, e, S, gtimes, gcolsum, gX):
        """The choice solve's d loss / d z of task j in the reference's
        order, from its times' cotangent, the area sums' and (with
        use_comm) its marginals', through the softmax of row e / S."""
        gx = np.array([_fma(self.ar[j, c], gcolsum[c],
                            f32(self.pch[j, c] * gtimes))
                       for c in range(self.C)], f32)
        if gX is not None:
            gx = np.array([f32(gx[c] + _dot_fma(gX, self.tm[:, c]))
                           for c in range(self.C)], f32)
        inv_s2 = f32(f32(1) / f32(S * S))
        t = f32(0)
        for c in range(self.C):
            t = _fma(f32(gx[c] * inv_s2), e[c], t)
        return np.array([f32(f32(f32(gx[c] / S) - t) * e[c])
                         for c in range(self.C)], f32)

    def chain_all(self, e, S, gtimes, gcolsum, gdelay, X):
        gz = np.zeros((self.n, self.C), f32)
        for j in range(self.n):
            gX = self.gX_xla(j, gdelay, X) if X is not None else None
            gz[j] = self.chain_xla(j, e[j], S[j], gtimes[j], gcolsum, gX)
        return gz

    @staticmethod
    def tie(soft, g):
        """jnp.maximum(soft, 0)'s cotangent to soft: all of g above 0,
        half at 0, none below (a product, as the reference takes it)."""
        return f32(g * (f32(1) if soft > 0 else f32(0.5) if soft == 0
                        else f32(0)))

    def slot_adjoints(self, gs, st, E, ind, tau):
        """A task's slots' cotangents from its soft start's ``gs`` and
        S + 1e-30, its slots' weights E and which slots hit the max: each
        slot's gm [hit] + gS E / τ, gS = τ gs / S and gm the max's
        cotangent."""
        gS = f32(f32(tau * gs) / st)
        ge = [f32(f32(gS * v) / tau) for v in E]
        gm = f32(f32(gs - _seq_sum(ge)) / f32(sum(ind)))
        return [f32(f32(0) + _fma(gm, f32(1) if i else f32(0), v))
                for v, i in zip(ge, ind)]

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
                        s = f32(s + self.weight(pf, m, tau))
                    mv[j], sc[j] = m, s
                    start = _max(self.soft_start(m, s, tau), f32(0))
                f[j] = f32(start + t[j])
        return f, mv, sc

    def weight(self, pf, m, tau):
        ex = self.exp if self.choice else np.exp
        return ex(f32(f32(pf - m) / tau))

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
                for s, kk in self.succ(j):
                    pf = self.slot_finish(f, X, s, kk, j)
                    gp = f32(f32(sc[s] * np.exp(f32(f32(pf - mv[s]) / tau)))
                             / tau)
                    gf = f32(gf + gp)
                cj = f32(0)
                if self.pred[j, 0] >= 0:
                    soft = self.soft_start(mv[j], sc[j], tau)
                    gs = gf if soft > 0 else (f32(0.5) * gf if soft == 0
                                              else f32(0))
                    cj = f32(f32(gs * tau) / f32(sc[j] + TINY))
                sc[j] = cj
                gz[j] = self.chain(j, x, gf, grads, None)
        return gz

    def step_gather(self, x, X, tau, sums):
        """The gather design's gradient at x from the exact pass's load
        sums (the hybrid solve only)."""
        if self.choice:
            raise ValueError("the gather design models the hybrid solve "
                             "only")
        f, mv, sc = self.soft_forward(x, X, tau)
        M = block_reduce(list(f), self.nt, _max, NEG)
        sum_f = block_reduce([np.exp(f32(f32(v - M) / tau)) for v in f],
                             self.nt, _add, f32(0))
        cfin, grads = self.cotangents(M, sum_f, sums, tau)
        return self.reverse_gather(x, X, f, mv, sc, M, cfin, grads, tau)

    # -------------------------------------------------------------- sm90
    def fused_forward(self, x, X, tau, soft):
        """One walk: every task's hard finish and, with ``soft``, its soft
        finish, soft start and S + 1e-30, and each slot's weight in w (and
        whether it hit the max, in ``ind``)."""
        t = self.times(x)
        fh = np.zeros(self.n, f32)
        f = np.zeros(self.n, f32)
        sv = np.zeros(self.n, f32)
        st = np.zeros(self.n, f32)
        w = np.zeros((self.n, self.P), f32)
        ind = np.zeros((self.n, self.P), bool)
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
                            ind[j, kk] = w[j, kk] == m
                            e = self.weight(w[j, kk], m, tau)
                            w[j, kk] = e
                            s = f32(s + e)
                        soft_j = self.soft_start(m, s, tau)
                        start = _max(soft_j, f32(0))
                fh[j] = f32(hard + t[j])
                if soft:
                    f[j], sv[j], st[j] = f32(start + t[j]), soft_j, f32(s + TINY)
        return fh, f, sv, st, w, ind

    def reverse_push(self, x, X, e, sv, st, w, cfin, grads, tau):
        """The hybrid solve's reverse walk: each task's g_f from its
        successors' stored gp, then its own slots' gp = c w / tau in place;
        then the chain rule of every task."""
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
            gz[j] = self.chain(j, x, gfs[j], grads, None)
        return gz

    def reverse_push_xla(self, z, X, g0, sv, st, w, ind, gcolsum, tau):
        """The choice solve's reverse walk: each task's g_f from its
        finish cotangent and its successors' stored slot cotangents (in
        descending topological order), then its own slots' cotangents in
        place of their weights; then the chain rule of every task."""
        w = w.copy()
        gtimes = np.zeros(self.n, f32)
        for tasks in reversed(self.levels):
            for j in tasks:
                gf = g0[j]
                for s, kk in self.succ_rev[j]:
                    gf = f32(gf + w[s, kk])
                if self.pred[j, 0] >= 0:
                    slots = [kk for kk, _ in self.slots(j)]
                    gp = self.slot_adjoints(
                        self.tie(sv[j], gf), st[j], [w[j, kk] for kk in slots],
                        [ind[j, kk] for kk in slots], tau)
                    for kk, v in zip(slots, gp):
                        w[j, kk] = v
                gtimes[j] = f32(f32(0) + gf)
        e, S = self.softmax_parts(z)
        return self.chain_all(e, S, gtimes, gcolsum, w, X)

    def forward_sm90(self, x, X, tau, soft=True):
        """The fused walk and its merged reduction: (λ, load sums, the
        walk's arrays, M)."""
        fh, f, sv, st, w, ind = self.fused_forward(x, X, tau, soft)
        sums = self.load_sums(x)
        lam = self.lam(block_reduce(list(fh), self.nt, _max, NEG), sums)
        M = block_reduce(list(f), self.nt, _max, NEG) if soft else None
        return lam, sums, (f, sv, st, w, ind), M

    def step_sm90(self, x, X, tau, fwd, M, sums, z=None):
        f, sv, st, w, ind = fwd
        if self.choice:
            g0, gcolsum = self.choice_cotangents(f, M, sums, tau)
            return self.reverse_push_xla(z, X, g0, sv, st, w, ind, gcolsum,
                                         tau)
        e = np.array([np.exp(f32(f32(v - M) / tau)) for v in f], f32)
        sum_f = block_reduce(list(e), self.nt, _add, f32(0))
        cfin, grads = self.cotangents(M, sum_f, sums, tau)
        return self.reverse_push(x, X, e, sv, st, w, cfin, grads, tau)


def _problem(d, **kw):
    kw = {k: v for k, v in kw.items() if v is not None}
    return Problem(d, **kw)


def gradient(d, z, tau, *, m, k):
    """The gather kernel's gradient of the hybrid loss at logits ``z``
    (n,) and temperature ``tau`` on ``m`` CPUs and ``k`` GPUs."""
    pr = _problem(d, m=m, k=k)
    x = pr.mix(_np(z).astype(f32))
    return pr.step_gather(x, None, f32(tau), pr.load_sums(x))


def gradient_sm90(d, z, tau, **kw):
    """The sm90 kernel's gradient of the loss at logits ``z`` and
    temperature ``tau``: the hybrid solve's ((n,) logits, ``m`` and ``k``)
    or, given ``p_choice``, the choice solve's ((n, C) logits; ``exp`` and
    ``log`` its transcendentals, numpy's by default)."""
    pr = _problem(d, **kw)
    z = _np(z).astype(f32)
    x = pr.mix(z)
    X = pr.marginals(x)
    _, sums, fwd, M = pr.forward_sm90(x, X, f32(tau))
    return pr.step_sm90(x, X, f32(tau), fwd, M, sums, z)


def _adam(z, mu, nu, gz, bc1, bc2):
    lr, b1, b2, eps, ob1, ob2 = ADAM
    mu = (b1 * mu + (ob1 * gz).astype(f32)).astype(f32)
    nu = (b2 * nu + ((ob2 * gz).astype(f32) * gz).astype(f32)).astype(f32)
    step = ((lr * (mu / bc1).astype(f32)).astype(f32)
            / (np.sqrt((nu / bc2).astype(f32)) + eps).astype(f32)).astype(f32)
    return (z - step).astype(f32), mu, nu


def solve(d, z0, iters, sched, *, design, **kw):
    """A whole solve in one design (``"gather"``, the hybrid solve only,
    or ``"sm90"``) from
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
        gz = pr.step_sm90(x, X, tau, fwd, M, sums, z)
        grads.append(gz)
        z, mu, nu = _adam(z, mu, nu, gz, sched[i, 1], sched[i, 2])
        x = pr.mix(z)
        X = pr.marginals(x)
    return best_x, best, grads


# ------------------------------------------------- the reference's backward
def _fma(a, b, c):
    """One rounding of a * b + c (float32 inputs), as a fused multiply-add.
    The float64 product is exact; the float64 sum is rounded to odd (an
    inexact sum moves to its neighbour whose last bit is 1, from TwoSum's
    exact error), so its rounding to float32 is the exact value's."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = np.asarray(p + c)
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(np.int64) & 1) == 0
    up = np.nextafter(s, np.where(err > 0, np.inf, -np.inf))
    return np.where((err != 0) & even & np.isfinite(s), up,
                    s).astype(f32)[()]


def _seq_sum(vals):
    """((0 + v0) + v1) + ... in float32, over the first axis."""
    acc = np.zeros(np.shape(vals)[1:], f32)
    for v in vals:
        acc = (acc + v).astype(f32)
    return acc


def _window_sum(v):
    """XLA:CPU's sum over the first axis of ``v``: windows of 32 (the axis
    padded to a multiple of 32, the padding split between the ends), each
    summed in order, then the windows' sums in order."""
    n = v.shape[0]
    lo = (-(-n // 32) * 32 - n) // 2
    bounds = range(-lo, n, 32)
    return _seq_sum([_seq_sum(v[max(b, 0):b + 32]) for b in bounds])


def _dot_fma(a, b):
    """sum_k a[..., k] b[..., k] as XLA:CPU's dot emits it: the first
    product rounded, each later one added by a contracted multiply-add."""
    acc = (a[..., 0] * b[..., 0]).astype(f32)
    for k in range(1, a.shape[-1]):
        acc = _fma(a[..., k], b[..., k], acc)
    return acc


def choice_grad_xla_order(topo, pred, mask, comm, z, tau, p, area, tm, inv,
                          *, exp, log):
    """The gradient of ``repro.core.hlp_jax._solve_choice``'s loss (with
    ``use_comm``) at logits ``z`` (n, C), written out in the order of the
    program XLA:CPU compiles for ``jax.jit(jax.grad(loss))``: its forward
    scan over ``topo`` (one task a step, its residuals kept a step), the
    smooth max's cotangents, the reverse scan (each task's cotangent set to
    0 after use and scattered into its predecessors slot by slot), then
    the marginals' and the softmax's transposes.  Every multiply-add that
    XLA fuses into one kernel is one rounding (:func:`_fma`); every sum
    runs in XLA:CPU's order (two-element rows left to right, sums over
    tasks by :func:`_window_sum`, dots by :func:`_dot_fma`).  ``exp`` and
    ``log`` map a float32 array to its float32 image (any array type):
    jitted ``jnp.exp`` / ``jnp.log`` reproduce the reference's
    transcendentals, ``torch.exp`` / ``torch.log`` the plain version's.  Float32 numpy arrays in and
    out; ``pred`` -1 after the last real slot (a masked slot reads task
    n - 1, as XLA's gather wraps it, and carries no cotangent)."""
    def exp_(v, fn=exp):
        return np.asarray(fn(np.asarray(v, f32)), f32)

    def log_(v, fn=log):
        return np.asarray(fn(np.asarray(v, f32)), f32)
    exp, log = exp_, log_
    n, C = z.shape
    P = pred.shape[1]
    tau = f32(tau)
    z, p, area, tm, inv, comm = (np.asarray(a, f32) for a in
                                 (z, p, area, tm, inv, comm))
    predw = np.where(pred < 0, pred + n, pred)
    # the softmax and the forward's inputs
    e = exp((z - z.max(axis=1, keepdims=True)).astype(f32))
    S = _seq_sum(e.T)
    inv_s2 = (f32(1) / (S * S).astype(f32)).astype(f32)
    x = (e / S[:, None]).astype(f32)
    X = _dot_fma(x[:, None, :], tm[None, :, :])                  # (n, Q)
    times = np.zeros(n, f32)
    for c in range(C):
        times = _fma(p[:, c], x[:, c], times)
    colsum = _window_sum((area * x).astype(f32))                 # (C,)
    loads_pre = _dot_fma(tm, colsum[None, :])                    # (Q,)
    Xp = X[predw]                                                # (n, P, Q)
    cross = _dot_fma(Xp, X[:, None, :])
    delay = (comm * (f32(1) - cross)).astype(f32)
    # the forward scan and its residuals, by scan position
    finish = np.zeros(n, f32)
    E = np.zeros((n, P), f32)
    S1, cnt, tie = (np.zeros(n, f32) for _ in range(3))
    IND = np.zeros((n, P), f32)
    has = np.zeros(n, bool)
    for i in range(n):
        j = topo[i]
        pf = np.where(mask[j], (finish[predw[j]] + delay[j]).astype(f32),
                      NEG)
        m = pf.max()
        ee = exp(((pf - m).astype(f32) / tau).astype(f32))
        E[i], IND[i] = ee, (pf == m).astype(f32)
        cnt[i] = f32((pf == m).sum())
        S1[i] = (_seq_sum(ee) + TINY).astype(f32)
        soft = _fma(tau, log(np.asarray(S1[i], f32)), m)
        top = max(soft, f32(0))
        tie[i] = f32(float(soft == top) / (2.0 if top == 0 else 1.0))
        has[i] = bool(mask[j].any())
        finish[j] = ((top if has[i] else f32(0)) + times[j]).astype(f32)
    # the smooth max of the critical path and the loads
    mfin = finish.max()
    ef = exp(((finish - mfin).astype(f32) / tau).astype(f32))
    Sf = _window_sum(ef)
    cntf = _window_sum((finish == mfin).astype(f32))
    cp = _fma(tau, log(np.asarray(Sf + TINY, f32)), mfin)
    loads = (loads_pre * inv).astype(f32)
    mx = max(cp, loads.max())
    terms = np.concatenate([[cp], loads]).astype(f32)
    et = exp(((terms - mx).astype(f32) / tau).astype(f32))
    r = (tau / _seq_sum(et)).astype(f32)
    gterm = ((r * et).astype(f32) / tau).astype(f32)
    gmx = ((-_seq_sum(gterm) + f32(1)).astype(f32)
           / f32((terms == mx).sum())).astype(f32)
    gsel = (gterm + np.where(terms == mx, gmx, f32(0))).astype(f32)
    gload = (gsel[1:] * inv).astype(f32)
    gcp = gsel[0]
    gSf = ((tau * gcp).astype(f32) / (Sf + TINY).astype(f32)).astype(f32)
    gcolsum = _dot_fma(gload[None, :], tm.T)                     # (C,)
    gef = ((gSf * ef).astype(f32) / tau).astype(f32)
    gmfin = ((gcp + (-_window_sum(gef))).astype(f32) / cntf).astype(f32)
    gfinish = (gef + np.where(finish == mfin, gmfin, f32(0))).astype(f32)
    # the reverse scan
    gtimes = np.zeros(n, f32)
    gdelay = np.zeros((n, P), f32)
    for i in range(n - 1, -1, -1):
        j = topo[i]
        gsoft = ((gfinish[j] if has[i] else f32(0)) * tie[i]).astype(f32)
        gS = ((tau * gsoft).astype(f32) / S1[i]).astype(f32)
        gtimes[j] = (gtimes[j] + gfinish[j]).astype(f32)
        gfinish[j] = f32(0)
        ge = ((gS * E[i]).astype(f32) / tau).astype(f32)
        gm = ((gsoft + (-_seq_sum(ge))).astype(f32) / cnt[i]).astype(f32)
        gpf = np.where(mask[j], _fma(gm, IND[i], ge), f32(0))
        gdelay[j] = (gdelay[j] + gpf).astype(f32)
        for s in range(P):
            gfinish[predw[j, s]] = (gfinish[predw[j, s]] + gpf[s]).astype(f32)
    # the crossings' transpose into the marginals, then the softmax's
    gcross = (-(comm * gdelay).astype(f32)).astype(f32)
    gX = _dot_fma(np.swapaxes(Xp, 1, 2), gcross[:, None, :])     # (n, Q)
    for a in range(n):
        for s in range(P):
            gX[predw[a, s]] = (gX[predw[a, s]]
                               + (gcross[a, s] * X[a]).astype(f32)
                               ).astype(f32)
    gxX = _dot_fma(gX[:, None, :], tm.T[None, :, :])             # (n, C)
    gx = (_fma(area, gcolsum[None, :], (p * gtimes[:, None]).astype(f32))
          + gxX).astype(f32)
    t = np.zeros(n, f32)
    for c in range(C):
        t = _fma((gx[:, c] * inv_s2).astype(f32), e[:, c], t)
    return (((gx / S[:, None]).astype(f32) + (-t)[:, None]).astype(f32)
            * e).astype(f32)
