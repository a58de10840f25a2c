"""HLP / QHLP — the paper's allocation linear program (+ rounding).

HLP (hybrid, Q=2) minimizes λ over fractional allocations x_j ∈ [0,1]
(x_j = CPU share) subject to Graham's lower bounds:

    minimize λ
    C_i + p̄_j x_j + p_j (1-x_j) <= C_j     ∀ (i,j) ∈ E          (1)
           p̄_j x_j + p_j (1-x_j) <= C_j     ∀ j with no preds    (2)
    C_j <= λ                                                     (3)
    (1/m) Σ p̄_j x_j <= λ                                        (4)
    (1/k) Σ p_j (1-x_j) <= λ                                     (5)

Rounding (paper §3): x_j >= 1/2  ->  CPU side, else GPU side.

The LP optimum is degenerate: off-critical-path tasks with load slack can sit
anywhere in [0, 1] without moving λ, so two optimal solvers (HiGHS here, the
first-order JAX solver in the JAX package's ``repro.core.hlp_jax``) legitimately return
different fractional solutions and hence different rounded allocations.
``canonical_round`` removes that freedom with a *shared deterministic
tie-break*: every task whose side is not pinned by λ is snapped to its
faster side, in natural task order, accepting a snap only while λ stays
within a small slack of the input solution's λ.  Passing ``canonical=True``
to either solver routes its rounding through this function, which makes the
two solvers' allocations comparable task-wise (asserted in
``tests/test_sim_bounds.py``); the default rounding is unchanged.

QHLP (Q >= 2, paper §5): variables x_{j,q}, Σ_q x_{j,q} = 1; rounding to
argmax_q x_{j,q}, ties broken toward the smallest processing time.

MHLP (moldable HLP, beyond-paper): when the graph carries speedup curves
(``TaskGraph.speedup``) the allocation variable is width-indexed —
x_{j,q,w} is the fraction of task j assigned to a width-w slot of pool q,
its length is p_{j,q}/speedup_j(w) and its *area* w·p_{j,q}/speedup_j(w)
enters pool q's load bound.  ``solve_mhlp`` rounds to the per-task argmax
``(type, width)`` — a ``repro_torch.platform.Decision`` — and
``canonical_round_moldable`` extends the deterministic degeneracy-free
tie-break to the width axis.  With a one-column curve table MHLP is exactly
QHLP (and, at Q=2, its optimum equals HLP's).

Since the comm-aware-allocation refactor every solver below is a thin
wrapper: the problem itself — choice grid, per-choice times, area terms and
(optionally) per-edge transfer costs — is one shared
``repro_torch.core.allocation.AllocationProblem`` IR, and the constraint matrices
come from its two lowerings (``hybrid_lp`` for the paper's scalar-x hybrid
LP, ``grid_lp`` for QHLP/MHLP).  Passing ``comm_aware=True`` prices each
edge's transfer cost into the allocation phase (crossing linearized with
coupling variables; see ``allocation.py``): the LP then *sees the network*
instead of leaving it to the scheduling phase.  With zero edge costs the
comm-aware problem is byte-identical to the oblivious one — the paper's
model, golden-tested bit-for-bit.

Solved exactly with scipy's HiGHS (the paper used GLPK).  The JAX package's
first-order solver (``repro.core.hlp_jax``) is not yet ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.optimize import linprog

from repro_torch.obs import registry as _obs
from repro_torch.platform import Decision, as_platform

# mhlp_choices / _choice_times moved to the IR module; re-imported here so
# historical ``from repro_torch.core.hlp import ...`` call sites keep working.
from .allocation import (AllocationProblem, _choice_times, frac_objective,
                         grid_lp, hybrid_lp, mhlp_choices)
from .dag import CPU, GPU, TaskGraph


@dataclasses.dataclass(frozen=True)
class HLPSolution:
    """Fractional LP solution + the rounded integral allocation."""
    x_frac: np.ndarray      # (n,) hybrid CPU share, (n, Q) for QHLP, or
    #                         (n, C) over (type, width) choices for MHLP
    lp_value: float         # λ* — a lower bound on the optimal makespan
    alloc: np.ndarray       # (n,) int — rounded resource type per task
    status: str = "optimal"
    width: np.ndarray | None = None   # (n,) rounded widths (MHLP only)

    @property
    def decisions(self) -> tuple[Decision, ...]:
        """The rounded allocation as first-class ``Decision`` records."""
        from repro_torch.platform import decisions_of
        return decisions_of(self.alloc, self.width)


def _linprog(lp):
    """Run one assembled LP through HiGHS, returning the ``OptimizeResult``
    (callers read ``res.x`` / ``res.fun``)."""
    with _obs.span("lp.solve", variables=len(lp.c)):
        res = linprog(lp.c, A_ub=lp.A_ub, b_ub=lp.b_ub, A_eq=lp.A_eq,
                      b_eq=lp.b_eq, bounds=lp.bounds, method="highs")
    if not res.success:
        raise RuntimeError(f"allocation LP failed: {res.message}")
    return res


# --------------------------------------------------------------------- hybrid
def canonical_round(g: TaskGraph, m: int, k: int, x: np.ndarray, *,
                    slack: float = 0.02,
                    prob: AllocationProblem | None = None) -> np.ndarray:
    """Deterministic degeneracy-free rounding of a (near-)optimal hybrid x.

    The input ``x`` enters only through its λ: the λ budget is
    ``λ(x)·(1 + slack)``, and the construction itself is a pure function of
    ``(g, m, k, budget)`` — tasks are processed in natural order against a
    deterministic context in which every undecided task sits on its faster
    side, each task taking its faster side if the context's λ stays within
    budget and the slower side otherwise.  Two near-optimal fractional
    solutions of the same instance therefore yield identical allocations
    unless some decision's λ lands inside their (sub-percent) λ gap.

    With a comm-aware ``prob``, both the budget and every context λ price
    the edge transfer costs, so the tie-break accounts for the *marginal
    transfer cost* of flipping a task's type — a task whose flip would put
    a heavy edge across the type boundary keeps its side even when the
    compute-only λ would let it move.

    Cost: up to two full λ evaluations per task, O(n·(n+e)) total — fine
    for the parity-test sizes this opt-in mode exists for; keep the default
    threshold rounding on large instances.
    """
    if prob is not None and prob.comm_aware:
        budget = frac_objective(prob, np.stack([x, 1.0 - x], axis=1)) \
            * (1.0 + slack)

        def lam(y: np.ndarray) -> float:
            # integral context: the engine-identical comm-charged bound
            return g.graham_lower_bound(
                [m, k], np.where(y >= 0.5, CPU, GPU).astype(np.int32))
    else:
        budget = g.lp_objective([m, k], x) * (1.0 + slack)
        lam = lambda y: g.lp_objective([m, k], y)

    with _obs.span("lp.canonical_round", n=g.n, slack=slack):
        pc, pg = g.proc[:, CPU], g.proc[:, GPU]
        fast = (pc <= pg).astype(np.float64)    # 1 = CPU is the faster side
        y = fast.copy()                         # context: undecided -> faster
        for j in range(g.n):
            lam_fast = lam(y)                   # y[j] already sits at fast[j]
            if lam_fast > budget:
                # over budget on the faster side: keep whichever side hurts
                # the context λ less (the budget stays the shared reference)
                y[j] = 1.0 - fast[j]
                if lam(y) > max(budget, lam_fast):
                    y[j] = fast[j]
        return np.where(y >= 0.5, CPU, GPU).astype(np.int32)


def solve_hlp(g: TaskGraph, m: int, k: int, *, canonical: bool = False,
              comm_aware: bool = False,
              contention: bool = False) -> HLPSolution:
    """Exact LP relaxation of HLP for the hybrid (m CPUs, k GPUs) platform.

    ``comm_aware=True`` prices each edge's transfer cost into the LP (one
    crossing variable per edge, charged on the edge's precedence row); on a
    zero-``comm`` graph the assembled LP — and hence the solution — is
    byte-identical to the oblivious one.  ``contention=True`` additionally
    scales each edge's price by its expected link load (see
    ``allocation.expected_link_load``) so the LP anticipates a contended
    network model.
    """
    if g.num_types != 2:
        raise ValueError("solve_hlp is for Q=2; use solve_qhlp")
    n = g.n
    prob = AllocationProblem.build(g, (m, k), comm_aware=comm_aware,
                                   rigid=True, contention=contention)
    res = _linprog(hybrid_lp(prob))
    x = np.clip(res.x[:n], 0.0, 1.0)
    alloc = (canonical_round(g, m, k, x, prob=prob) if canonical
             else np.where(x >= 0.5, CPU, GPU).astype(np.int32))
    return HLPSolution(x_frac=x, lp_value=float(res.fun), alloc=alloc)


# ------------------------------------------------------------------- Q types
def solve_qhlp(g: TaskGraph, counts, *,
               comm_aware: bool = False,
               contention: bool = False) -> HLPSolution:
    """Exact LP relaxation of QHLP for Q >= 2 resource types (paper §5).

    ``comm_aware=True`` prices edge transfer costs with per-edge type
    couplings (see ``repro_torch.core.allocation``); zero comm assembles the
    byte-identical historical LP.  ``contention=True`` scales edge prices
    by the expected link load of a contended network.
    """
    counts = as_platform(counts, warn=False).to_counts()
    n, q = g.n, g.num_types
    if len(counts) != q:
        raise ValueError(f"need {q} machine counts, got {len(counts)}")
    p = g.proc  # (n, Q)
    prob = AllocationProblem.build(g, counts, comm_aware=comm_aware,
                                   rigid=True, contention=contention)
    res = _linprog(grid_lp(prob))
    x = res.x[: n * q].reshape(n, q)

    # Rounding: argmax_q x_{j,q}; ties -> smallest processing time.
    alloc = np.empty(n, dtype=np.int32)
    for j in range(n):
        best = x[j].max()
        cand = np.flatnonzero(x[j] >= best - 1e-9)
        alloc[j] = cand[np.argmin(p[j, cand])]
    return HLPSolution(x_frac=x, lp_value=float(res.fun), alloc=alloc)


def lp_lower_bound(g: TaskGraph, counts, *,
                   comm_aware: bool | None = None) -> float:
    """LP* — the paper's denominator for experimental ratios.

    Moldable graphs route through the width-indexed MHLP relaxation (its
    feasible set contains every (type, width) schedule, so its λ* is the
    right denominator there).  By default the LP prices the graph's edge
    transfer costs whenever it carries any (``comm_aware=None`` — every
    schedule the engine measures pays them, so the comm-aware λ* is both
    valid and tighter on network-bound instances); pass ``False`` for the
    paper's transfer-free denominator."""
    platform = as_platform(counts, warn=False)
    ca = bool(g.has_comm) if comm_aware is None else comm_aware
    if g.max_width > 1:
        return solve_mhlp(g, platform, comm_aware=ca).lp_value
    if g.num_types == 2:
        return solve_hlp(g, platform.counts[0], platform.counts[1],
                         comm_aware=ca).lp_value
    return solve_qhlp(g, platform.to_counts(), comm_aware=ca).lp_value


# ----------------------------------------------------------- moldable (MHLP)
def _mhlp_objective_frac(g: TaskGraph, counts, x: np.ndarray,
                         choices, p_choice: np.ndarray) -> float:
    """Back-compat shim: the comm-oblivious fractional λ — now one call to
    the IR's :func:`repro_torch.core.allocation.frac_objective`."""
    prob = AllocationProblem(g=g, counts=tuple(int(c) for c in counts),
                             choices=tuple(choices), p_choice=p_choice,
                             finite=np.isfinite(p_choice),
                             comm=np.zeros(g.num_edges))
    return frac_objective(prob, x)


def canonical_round_moldable(g: TaskGraph, machine, x: np.ndarray, *,
                             slack: float = 0.02,
                             prob: AllocationProblem | None = None
                             ) -> tuple[np.ndarray, np.ndarray]:
    """``canonical_round`` extended to the width axis.

    Same construction, over (type, width) choices: the λ budget is the input
    distribution's λ·(1+slack); tasks are processed in natural order against
    a context in which every undecided task sits on its *fastest* choice,
    each task taking the fastest choice whose context λ stays within budget
    (candidates tried in ascending processing time, ties toward narrower
    widths) and otherwise the choice minimizing the context λ.  Two
    near-optimal fractional MHLP solutions therefore round identically
    unless a decision's λ lands inside their λ gap.  With a comm-aware
    ``prob`` the budget prices the edge transfer costs (the integral
    context λ, ``graham_lower_bound``, always has).  O(n·C·(n+e)) — a
    parity/comparability tool, not the default rounding.
    """
    platform = as_platform(machine, warn=False)
    counts = platform.to_counts()
    if prob is None:
        prob = AllocationProblem.build(g, platform)
    choices, p_choice = prob.choices, prob.p_choice
    budget = frac_objective(prob, x) * (1.0 + slack)
    # candidate order per task: ascending time, ties toward narrow widths
    order = [sorted(range(len(choices)),
                    key=lambda c: (p_choice[j, c], choices[c][1]))
             for j in range(g.n)]
    pick = np.asarray([o[0] for o in order], dtype=np.int64)

    def lam_of(picked: np.ndarray) -> float:
        alloc = np.asarray([choices[c][0] for c in picked], dtype=np.int32)
        width = np.asarray([choices[c][1] for c in picked], dtype=np.int32)
        return g.graham_lower_bound(counts, alloc, width)

    with _obs.span("lp.canonical_round", n=g.n, slack=slack, moldable=True):
        for j in range(g.n):
            best_c, best_lam = pick[j], np.inf
            for c in order[j]:
                pick[j] = c
                lam = lam_of(pick)
                if lam <= budget:
                    best_c = c
                    break
                if lam < best_lam:
                    best_c, best_lam = c, lam
            pick[j] = best_c
        alloc = np.asarray([choices[c][0] for c in pick], dtype=np.int32)
        width = np.asarray([choices[c][1] for c in pick], dtype=np.int32)
        return alloc, width


def solve_mhlp(g: TaskGraph, machine, *, canonical: bool = False,
               comm_aware: bool = False,
               contention: bool = False) -> HLPSolution:
    """Exact LP relaxation of moldable HLP over (type, width) choices.

    Variables x_{j,q,w} ∈ [0,1] with Σ_{q,w} x_{j,q,w} = 1 per task;
    fractional length ℓ_j = Σ p_{j,q,w} x_{j,q,w}; constraints are QHLP's
    (9)–(13) with the load bound charging the *area* w·p_{j,q,w} a width-w
    slot really occupies.  With a width-1 curve table this is exactly QHLP.
    ``comm_aware=True`` additionally prices each edge's transfer cost on
    its precedence row (type couplings; the width-indexed choice grid is
    where the edge terms hang).  Rounding: per-task argmax over choices,
    ties toward the smallest processing time then the narrower width — or
    the deterministic ``canonical_round_moldable`` tie-break with
    ``canonical=True``.
    """
    platform = as_platform(machine)
    n = g.n
    if len(platform.counts) != g.num_types:
        raise ValueError(
            f"need {g.num_types} pool counts, got {len(platform.counts)}")
    prob = AllocationProblem.build(g, platform, comm_aware=comm_aware,
                                   contention=contention)
    choices, p_choice = prob.choices, prob.p_choice
    C = prob.C
    res = _linprog(grid_lp(prob))
    x = np.clip(res.x[: n * C].reshape(n, C), 0.0, 1.0)

    if canonical:
        alloc, width = canonical_round_moldable(g, platform, x, prob=prob)
    else:
        alloc = np.empty(n, dtype=np.int32)
        width = np.empty(n, dtype=np.int32)
        for j in range(n):
            best = x[j].max()
            cand = np.flatnonzero(x[j] >= best - 1e-9)
            c = int(cand[np.lexsort((
                [choices[int(cc)][1] for cc in cand],
                p_choice[j, cand]))[0]])
            alloc[j], width[j] = choices[c]
    return HLPSolution(x_frac=x, lp_value=float(res.fun), alloc=alloc,
                       width=width)
