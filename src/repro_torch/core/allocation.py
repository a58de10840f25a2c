"""The shared allocation-problem IR behind every LP solver.

The paper's allocation phase is a family of LP relaxations — hybrid HLP
(Q=2), QHLP (Q >= 2) and the width-indexed moldable MHLP — that the repo
solves with two backends: exact HiGHS (``repro_torch.core.hlp``) and a jitted
first-order JAX solver (the JAX package's ``repro.core.hlp_jax``, not yet
ported).  Historically each solver
assembled its own objective and constraints; this module factors the whole
problem into one **``AllocationProblem``** intermediate representation that
every backend consumes:

  * the (task × (type, width)) **choice grid** — ``choices[c] = (q, w)``,
    per-choice processing times ``p_choice[j, c]`` and width-weighted areas
    (the load a width-w slot really occupies);
  * the **per-edge communication terms** — when the problem is built
    ``comm_aware``, each DAG edge carries its transfer cost and the LP
    charges it whenever the edge's endpoints take choices of *different
    type*.  The paper's model prices transfers at zero: an oblivious
    problem (or a zero-``comm`` graph) assembles the byte-identical LP the
    pre-comm solvers produced, so every golden is preserved bit-for-bit.

Exact backend (``grid_lp`` / ``hybrid_lp``): the product of the two
endpoints' type indicators is linearized with standard coupling variables
``z[e, q, q']`` (mass of edge ``e`` whose tail runs on type ``q`` and head
on type ``q'``) whose marginals must match the endpoints' fractional type
shares; the edge's precedence row then charges ``comm_e · Σ_{q≠q'} z``.
Minimizing λ drives the coupling to the minimum-crossing one, so the
fractional crossing cost is exactly the total-variation distance between
the endpoint type distributions — and on integral solutions the 0/1
cross-type indicator, i.e. the same cost the engine charges at replay.
For the hybrid (Q=2) lowering the coupling collapses to one variable
``z_e >= |x_i - x_j|`` per edge.

First-order backend: :func:`frac_objective` evaluates the exact λ of any
fractional choice distribution, pricing edges at the same total-variation
crossing probability; ``repro.core.hlp_jax`` optimizes a smooth surrogate
(expected crossing under independent draws, an upper bound on the TV term)
folded into the soft longest path as comm-augmented edge delays.

Every λ produced by these relaxations lower-bounds the comm-charged
optimal makespan, so :func:`repro_torch.core.hlp.lp_lower_bound` stays a valid —
and, on network-bound instances, strictly tighter — ratio denominator.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from repro_torch.obs import registry as _obs
from repro_torch.platform import as_platform

from .dag import TaskGraph


def task_comm_price(g: TaskGraph, alloc, comm=None,
                    direction: str = "in") -> np.ndarray:
    """(n,) transfer cost each task pays under ``alloc``: the sum of
    ``comm[e]`` over its cross-type edges — incoming (``direction="in"``,
    the cost charged into the task's readiness, what the engine's replay
    delays it by), outgoing (``"out"``), or all incident (``"both"``, the
    full price a task's placement puts on the network — what a provenance
    record quotes, since flipping the task moves *every* incident edge).

    ``comm=None`` prices the graph's own edge costs; pass an alternative
    per-edge vector (e.g. the contention-scaled ``AllocationProblem.comm``)
    to price what an LP objective saw instead.
    """
    if direction not in ("in", "out", "both"):
        raise ValueError(f"direction must be 'in', 'out' or 'both', "
                         f"got {direction!r}")
    price = np.zeros(g.n)
    if not g.num_edges:
        return price
    c = np.asarray(g.comm if comm is None else comm, dtype=np.float64)
    a = np.asarray(alloc)
    cross = a[g.edges[:, 0]] != a[g.edges[:, 1]]
    if direction in ("in", "both"):
        np.add.at(price, g.edges[cross, 1], c[cross])
    if direction in ("out", "both"):
        np.add.at(price, g.edges[cross, 0], c[cross])
    return price


def expected_link_load(g: TaskGraph, counts) -> np.ndarray:
    """(e,) expected number of transfers sharing each edge's link — the
    contention prior the allocation phase can price before any placement
    exists.

    Heuristic: edges whose *source* tasks sit on the same topological level
    tend to transfer in the same execution window (that is exactly the
    netbound failure mode); under a uniform random-placement prior an edge
    crosses the type boundary with probability ``1 - Σ_q (c_q/Σc)²``, and
    crossing peers split evenly between the two link directions.  So an
    edge with ``peers`` same-level companions expects
    ``1 + p_cross · (peers - 1) / 2`` concurrent flows on its bottleneck
    link.  Always ≥ 1, and exactly 1 when an edge has no level peers — a
    contention-scaled problem on an uncontended graph prices the same comm.
    """
    if not g.num_edges:
        return np.zeros(0)
    total = float(sum(counts))
    p_cross = 1.0 - sum((float(c) / total) ** 2 for c in counts)
    src_level = g.level[g.edges[:, 0]]
    peers = np.bincount(src_level)[src_level].astype(np.float64)
    return 1.0 + p_cross * (peers - 1.0) * 0.5


def mhlp_choices(g: TaskGraph, counts) -> list[tuple[int, int]]:
    """The (type, width) decision grid of the width-indexed LP: every pool
    crossed with widths 1..min(max curve width, pool size)."""
    return [(q, w) for q in range(g.num_types)
            for w in range(1, min(g.max_width, int(counts[q])) + 1)]


def _choice_times(g: TaskGraph, choices: list[tuple[int, int]]) -> np.ndarray:
    """(n, C) processing time of each task under each (type, width) choice."""
    cols = [g.proc[:, q] if w == 1 or g.speedup is None
            else g.proc[:, q] / g.speedup[:, w - 1]
            for q, w in choices]
    return np.stack(cols, axis=1)


@dataclasses.dataclass(frozen=True)
class AllocationProblem:
    """The one IR every allocation LP is assembled from.

    Attributes:
      g:        the task graph (precedence, times, optional speedup curves).
      counts:   units per resource pool.
      choices:  the (type, width) decision grid.
      p_choice: (n, C) processing time of each task under each choice
                (``inf`` where a task cannot take the choice).
      finite:   (n, C) mask of usable choices.
      comm:     (e,) per-edge transfer cost the *allocation* prices — the
                graph's ``comm`` when built ``comm_aware``, zeros otherwise.
                An all-zero ``comm`` (the paper's model) assembles the
                byte-identical comm-free LP.
    """

    g: TaskGraph
    counts: tuple[int, ...]
    choices: tuple[tuple[int, int], ...]
    p_choice: np.ndarray
    finite: np.ndarray
    comm: np.ndarray

    @staticmethod
    def build(g: TaskGraph, machine, *, comm_aware: bool = False,
              rigid: bool = False,
              contention: bool = False) -> "AllocationProblem":
        """Build the IR from a graph and a machine.

        ``rigid=True`` forces the width-1 grid (one choice per pool) — the
        HLP/QHLP view — regardless of the graph's speedup curves;
        ``comm_aware=True`` prices the graph's edge transfer costs into the
        allocation (zero-cost edges contribute nothing, so ``ccr=0`` builds
        the identical problem either way).  ``contention=True`` (implies
        comm pricing is meaningful) scales each edge's price by its
        :func:`expected_link_load` — the level-peer concurrency prior a
        contended network model (``maxmin_fair``) will realize — so the LP
        values type locality the way the fluid engine charges it.
        """
        with _obs.span("lp.assemble", n=g.n, comm_aware=comm_aware,
                       contention=contention):
            platform = as_platform(machine, warn=False)
            counts = platform.to_counts()
            if rigid:
                choices = [(q, 1) for q in range(g.num_types)]
            else:
                choices = mhlp_choices(g, counts)
            p_choice = _choice_times(g, choices)
            comm = (np.asarray(g.comm, dtype=np.float64)
                    if comm_aware and g.num_edges
                    else np.zeros(g.num_edges, dtype=np.float64))
            if comm_aware and contention and g.num_edges:
                comm = comm * expected_link_load(g, counts)
            return AllocationProblem(
                g=g, counts=tuple(int(c) for c in counts),
                choices=tuple(choices), p_choice=p_choice,
                finite=np.isfinite(p_choice), comm=comm)

    # ------------------------------------------------------------ properties
    @property
    def n(self) -> int:
        return self.g.n

    @property
    def C(self) -> int:
        return len(self.choices)

    @property
    def num_types(self) -> int:
        return self.g.num_types

    @property
    def comm_aware(self) -> bool:
        """True when any edge cost is actually priced by this problem."""
        return bool(self.comm.size) and bool(self.comm.any())

    @property
    def type_of(self) -> np.ndarray:
        """(C,) resource type of each choice."""
        return np.asarray([q for q, _ in self.choices], dtype=np.int64)

    @property
    def width_of(self) -> np.ndarray:
        """(C,) width of each choice."""
        return np.asarray([w for _, w in self.choices], dtype=np.int64)

    @property
    def type_mask(self) -> np.ndarray:
        """(Q, C) pool-membership indicator of each choice."""
        mask = np.zeros((self.num_types, self.C))
        mask[self.type_of, np.arange(self.C)] = 1.0
        return mask

    def type_marginals(self, x: np.ndarray) -> np.ndarray:
        """(n, Q) per-type mass of an (n, C) choice distribution."""
        return x @ self.type_mask.T

    def cross_probability(self, x: np.ndarray) -> np.ndarray:
        """(e,) total-variation crossing probability of each edge under a
        fractional choice distribution — the tightest coupling's chance the
        two endpoints land on different types (0/1 on integral x)."""
        if not self.g.num_edges:
            return np.zeros(0)
        X = self.type_marginals(x)
        i, j = self.g.edges[:, 0], self.g.edges[:, 1]
        return 1.0 - np.minimum(X[i], X[j]).sum(axis=1)


def frac_objective(prob: AllocationProblem, x: np.ndarray) -> float:
    """Exact λ(x) of a fractional (n, C) choice distribution: critical path
    under the mixed lengths plus per-pool area loads, the path priced with
    the total-variation expected transfer cost of each edge when the
    problem is comm-aware.

    Infeasible (non-finite) choices contribute only where they carry mass:
    ``inf·0`` would otherwise poison the whole objective with NaN even
    though the LP correctly pinned those variables to zero.  With zero
    ``comm`` this performs the identical float operations the historical
    comm-free objective did.
    """
    g, counts, choices = prob.g, prob.counts, prob.choices
    # Mask the operands, not just the product: ``p_choice * x`` would
    # evaluate ``inf · 0`` on infeasible zero-mass choices and raise a
    # RuntimeWarning before the mask ever applied.  Finite entries see the
    # identical float multiply; infeasible choices carrying mass still
    # poison the objective with inf exactly as before.
    safe_p = np.where(prob.finite, prob.p_choice, 0.0)
    contrib = np.where(x > 0, safe_p * x, 0.0)          # (n, C)
    contrib = np.where(~prob.finite & (x > 0), np.inf, contrib)
    times = contrib.sum(axis=1)
    if prob.comm_aware:
        cross = np.clip(prob.cross_probability(x), 0.0, 1.0)
        lam = g.critical_path(times, edge_delay=prob.comm * cross)
    else:
        lam = g.critical_path(times)
    for q in range(g.num_types):
        sel = [c for c, (qq, _) in enumerate(choices) if qq == q]
        area = sum(float(choices[c][1]) * float(contrib[:, c].sum())
                   for c in sel)
        lam = max(lam, area / counts[q])
    return lam


# ----------------------------------------------------------- LP assembly
@dataclasses.dataclass(frozen=True)
class AssembledLP:
    """One ``scipy.optimize.linprog`` call's worth of HiGHS inputs."""

    c: np.ndarray
    A_ub: sp.csr_matrix
    b_ub: np.ndarray
    A_eq: sp.csr_matrix | None
    b_eq: np.ndarray | None
    bounds: list[tuple[float, float | None]]


class _RowBuilder:
    """Shared sparse-row accumulator (entries in insertion order, so the
    assembled matrix is byte-identical to the historical constructions)."""

    def __init__(self):
        self.rows, self.cols, self.vals, self.rhs = [], [], [], []
        self.r = 0

    def add(self, row_entries, b):
        for c_, v_ in row_entries:
            self.rows.append(self.r)
            self.cols.append(c_)
            self.vals.append(v_)
        self.rhs.append(b)
        self.r += 1

    def matrix(self, nv: int) -> tuple[sp.csr_matrix, np.ndarray]:
        A = sp.csr_matrix((self.vals, (self.rows, self.cols)),
                          shape=(self.r, nv))
        return A, np.asarray(self.rhs)


def hybrid_lp(prob: AllocationProblem) -> AssembledLP:
    """The paper's hybrid (Q=2, width-1) lowering: one scalar x_j = CPU
    share per task (the variable-reduced projection of the choice grid,
    kept because its HiGHS vertex is the historically golden one).

    Layout: ``[x_0..x_{n-1}, C_0..C_{n-1}, λ]`` — extended, when the
    problem is comm-aware, with one crossing variable ``z_e >= |x_i - x_j|``
    per positive-cost edge, charged ``comm_e · z_e`` on the edge's
    precedence row.  With zero comm the assembled matrix is byte-identical
    to the historical ``solve_hlp`` construction.
    """
    g, n = prob.g, prob.n
    if prob.C != 2 or prob.num_types != 2:
        raise ValueError("hybrid lowering needs the rigid Q=2 choice grid")
    m, k = prob.counts
    pc, pg = prob.p_choice[:, 0], prob.p_choice[:, 1]
    dp = pc - pg  # coefficient of x_j in the allocated length

    ce = np.flatnonzero(prob.comm > 0.0)   # edges whose crossing is priced
    zv = {int(e): 2 * n + 1 + i for i, e in enumerate(ce)}
    nv = 2 * n + 1 + len(ce)
    b = _RowBuilder()

    # (1) edge constraints: C_i - C_j + dp_j x_j (+ comm_e z_e) <= -p_j
    for e, (i, j) in enumerate(g.edges):
        ent = [(n + i, 1.0), (n + j, -1.0), (j, dp[j])]
        if e in zv:
            ent.append((zv[e], float(prob.comm[e])))
        b.add(ent, -pg[j])
    # (2) source constraints: dp_j x_j - C_j <= -p_j
    indeg = np.diff(g.pred_ptr)
    for j in np.flatnonzero(indeg == 0):
        b.add([(int(j), dp[j]), (n + int(j), -1.0)], -pg[j])
    # (3) C_j - λ <= 0
    for j in range(n):
        b.add([(n + j, 1.0), (2 * n, -1.0)], 0.0)
    # (4) (1/m) Σ pc_j x_j - λ <= 0
    b.add([(j, pc[j] / m) for j in range(n)] + [(2 * n, -1.0)], 0.0)
    # (5) (1/k) Σ pg_j (1 - x_j) <= λ
    b.add([(j, -pg[j] / k) for j in range(n)] + [(2 * n, -1.0)],
          -float(pg.sum()) / k)
    # (6) crossing linearization: z_e >= |x_i - x_j|
    for e in ce:
        i, j = int(g.edges[e, 0]), int(g.edges[e, 1])
        b.add([(i, 1.0), (j, -1.0), (zv[int(e)], -1.0)], 0.0)
        b.add([(j, 1.0), (i, -1.0), (zv[int(e)], -1.0)], 0.0)

    A_ub, b_ub = b.matrix(nv)
    c = np.zeros(nv)
    c[2 * n] = 1.0
    bounds = ([(0.0, 1.0)] * n + [(0.0, None)] * (n + 1)
              + [(0.0, 1.0)] * len(ce))
    return AssembledLP(c=c, A_ub=A_ub, b_ub=b_ub, A_eq=None, b_eq=None,
                       bounds=bounds)


def grid_lp(prob: AllocationProblem) -> AssembledLP:
    """The general (type, width) choice-grid LP — QHLP when the grid is
    rigid, MHLP when it carries widths (QHLP's (9)–(13) with the load bound
    charging the *area* ``w·p`` a width-w slot occupies).

    Layout: ``[x_{0,0}..x_{n-1,C-1}, C_0..C_{n-1}, λ]`` — extended, when
    the problem is comm-aware, with coupling variables ``z[e, q, q']`` per
    positive-cost edge whose marginals match the endpoints' type shares;
    the edge row charges ``comm_e · Σ_{q≠q'} z[e, q, q']``.  With zero comm
    the assembled matrix is byte-identical to the historical
    ``solve_qhlp``/``solve_mhlp`` constructions.
    """
    g, n, C, Q = prob.g, prob.n, prob.C, prob.num_types
    counts = prob.counts
    choices, p_choice, finite = prob.choices, prob.p_choice, prob.finite
    type_cols = [[c for c in range(C) if choices[c][0] == q]
                 for q in range(Q)]

    def xv(j: int, c: int) -> int:
        return j * C + c

    cv = lambda j: n * C + j
    lv = n * C + n
    ce = np.flatnonzero(prob.comm > 0.0)
    zbase = lv + 1

    def zv(ei: int, a: int, b_: int) -> int:
        return zbase + ei * Q * Q + a * Q + b_

    nv = zbase + len(ce) * Q * Q
    ub = _RowBuilder()

    # (9) C_i + Σ_c p_jc x_jc (+ comm_e Σ_{q≠q'} z) <= C_j
    cidx = {int(e): i for i, e in enumerate(ce)}
    for e, (i, j) in enumerate(g.edges):
        ent = [(cv(int(i)), 1.0), (cv(int(j)), -1.0)] \
            + [(xv(int(j), c), p_choice[j, c]) for c in range(C)
               if finite[j, c]]
        if e in cidx:
            ent += [(zv(cidx[e], a, b_), float(prob.comm[e]))
                    for a in range(Q) for b_ in range(Q) if a != b_]
        ub.add(ent, 0.0)
    # (10) Σ_c p_jc x_jc <= C_j for sources
    indeg = np.diff(g.pred_ptr)
    for j in np.flatnonzero(indeg == 0):
        ub.add([(xv(int(j), c), p_choice[j, c]) for c in range(C)
                if finite[j, c]] + [(cv(int(j)), -1.0)], 0.0)
    # (11) C_j <= λ
    for j in range(n):
        ub.add([(cv(j), 1.0), (lv, -1.0)], 0.0)
    # (12) per-pool area load
    for q in range(Q):
        ub.add([(xv(j, c), choices[c][1] * p_choice[j, c] / counts[q])
                for j in range(n) for c in range(C)
                if choices[c][0] == q and finite[j, c]] + [(lv, -1.0)], 0.0)
    A_ub, b_ub = ub.matrix(nv)

    # (13) Σ_c x_{j,c} = 1, then the coupling marginals per priced edge.
    eq = _RowBuilder()
    for j in range(n):
        eq.add([(xv(j, c), 1.0) for c in range(C)], 1.0)
    for ei, e in enumerate(ce):
        i, j = int(g.edges[e, 0]), int(g.edges[e, 1])
        for a in range(Q):      # Σ_{q'} z[e,a,q'] = tail's type-a share
            eq.add([(zv(ei, a, b_), 1.0) for b_ in range(Q)]
                   + [(xv(i, c), -1.0) for c in type_cols[a]], 0.0)
        for b_ in range(Q):     # Σ_q z[e,q,b'] = head's type-b' share
            eq.add([(zv(ei, a, b_), 1.0) for a in range(Q)]
                   + [(xv(j, c), -1.0) for c in type_cols[b_]], 0.0)
    A_eq, b_eq = eq.matrix(nv)

    c = np.zeros(nv)
    c[lv] = 1.0
    bounds = [(0.0, 0.0) if not finite[j, cc] else (0.0, 1.0)
              for j in range(n) for cc in range(C)] \
        + [(0.0, None)] * (n + 1) + [(0.0, 1.0)] * (len(ce) * Q * Q)
    return AssembledLP(c=c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                       bounds=bounds)
