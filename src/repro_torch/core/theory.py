"""Worst-case instance generators from the paper's lower-bound theorems.

These are used by the tests to validate the theory numerically:

* Theorem 1 — HEFT approximation ratio >= (m+k)/k² (1 - e^{-k}) for k <= √m,
  on an instance of independent tasks (sets A_i, B_i of Table 1).
* Theorem 2 — HLP-EST (and *any* scheduling policy after HLP rounding,
  Corollary 1) achieves ratio 6 - O(1/m) on the 3-set instance of Table 2.
* Theorem 4 — ER-LS achieves competitive ratio √(m/k) on the A/B-chain
  instance of Table 3.
"""
from __future__ import annotations

import numpy as np

from .dag import TaskGraph

#: stand-in for the paper's p_A = ∞ ("cannot run on GPU"); finite to keep the
#: LP bounded, large enough that no optimizer ever puts T_A on the GPU side.
BIG = 1e9


def heft_worstcase(m: int, k: int) -> TaskGraph:
    """Table 1: 2m sets of independent tasks; |A_i| = k, |B_i| = m."""
    assert k <= int(np.sqrt(m)) + 1e-9, "theorem requires k <= sqrt(m)"
    r = m / (m + k)
    pc, pg, names = [], [], []
    for i in range(1, m + 1):
        for _ in range(k):   # A_i: same time on both sides
            pc.append(r ** i); pg.append(r ** i); names.append(f"A{i}")
        for _ in range(m):   # B_i: strongly accelerated on GPU
            pc.append(r ** i); pg.append(k / m ** 2 * r ** m); names.append(f"B{i}")
    proc = np.stack([pc, pg], axis=1)
    return TaskGraph.build(proc, [], names=names)


def heft_worstcase_bound(m: int, k: int) -> float:
    return (m + k) / k ** 2 * (1.0 - np.exp(-k))


def hlp_worstcase(m: int) -> TaskGraph:
    """Table 2 (k = m): T_A + complete bipartite B_1 -> B_2 (2m+1 tasks each)."""
    assert m >= 3
    nB = 2 * m + 1
    pc = [m * (2 * m + 1) / (m - 1)] + [2 * m - 1] * nB + [1] * nB
    pg = [BIG] + [1] * nB + [2 * m - 1] * nB
    names = ["A"] + [f"B1_{i}" for i in range(nB)] + [f"B2_{i}" for i in range(nB)]
    edges = [(1 + i, 1 + nB + j) for i in range(nB) for j in range(nB)]
    return TaskGraph.build(np.stack([pc, pg], axis=1), edges, names=names)


def hlp_worstcase_fractional(m: int, eps: float = 1e-6) -> np.ndarray:
    """Proposition 1's adversarial *optimal* fractional solution: x_A = 1,
    x_{B1} = 1/2, x_{B2} = 1/2 - ε.  (The LP optimum is not unique; the lower
    bound holds for the rounding of THIS optimum, cf. Corollary 1.)"""
    nB = 2 * m + 1
    return np.concatenate([[1.0], np.full(nB, 0.5), np.full(nB, 0.5 - eps)])


def hlp_worstcase_lp_value(m: int) -> float:
    return m * (2 * m + 1) / (m - 1)


def hlp_worstcase_makespan(m: int) -> float:
    """Makespan of any reasonable policy after the adversarial rounding."""
    return 6.0 * (2 * m - 1)


def erls_worstcase(m: int, k: int) -> tuple[TaskGraph, np.ndarray]:
    """Table 3: k independent A tasks, then an m-task B chain.  Returns the
    graph and the adversarial arrival order (all A first, then the chain)."""
    sm, sk = np.sqrt(m), np.sqrt(k)
    pc = [sm] * k + [sm] * m
    pg = [sm] * k + [sk] * m
    edges = [(k + i, k + i + 1) for i in range(m - 1)]
    names = [f"A{i}" for i in range(k)] + [f"B{i}" for i in range(m)]
    g = TaskGraph.build(np.stack([pc, pg], axis=1), edges, names=names)
    return g, np.arange(g.n, dtype=np.int32)


def erls_optimal_makespan(m: int, k: int) -> float:
    """OPT for the Thm-4 instance: A on CPUs (√m), B chain on GPUs (m·√k)."""
    return max(np.sqrt(m), m * np.sqrt(k))


def erls_competitive_bound(m: int, k: int) -> float:
    """Theorem 3: ER-LS is at most 4·√(m/k)-competitive (m CPUs, k GPUs)."""
    return 4.0 * np.sqrt(m / k)


# --------------------------------------------------- universal lower bounds
def makespan_lower_bound(g: TaskGraph, counts) -> float:
    """A bound every feasible schedule obeys, independent of the algorithm:

        max( CP under per-task best-decision times,
             total best-type work / total machine count,
             largest single best-decision task ).

    Weaker than LP* but valid for *any* allocation (LP* assumes the
    allocation is free to be fractional; this never exceeds OPT either) —
    the property tests in ``tests/test_sim_*`` check every simulated
    schedule against it.

    On a moldable graph the CP/longest terms use the fully-widened times
    ``tmin / speedup[:, -1]`` (the fastest any (type, width) decision can
    run a task), while the area term keeps the width-1 ``tmin``: per-unit
    efficiency never exceeds 1, so a task's occupied area is minimized at
    width 1.  Curve-free graphs are untouched.
    """
    if hasattr(counts, "to_counts"):   # Platform (duck-typed: no sim import)
        counts = counts.to_counts()
    tmin = np.min(g.proc, axis=1)
    if not np.all(np.isfinite(tmin)):
        tmin = np.where(np.isfinite(tmin), tmin, 0.0)
    tfast = tmin if g.speedup is None else tmin / g.speedup[:, -1]
    cp = g.critical_path(tfast)
    total = float(sum(counts))
    area = float(tmin.sum()) / total if total else 0.0
    longest = float(tfast.max()) if tfast.size else 0.0
    return max(cp, area, longest)


def ratio_denominator(g: TaskGraph, counts, *, lp_max_n: int = 256) -> float:
    """The campaign's makespan-ratio denominator: the universal
    :func:`makespan_lower_bound`, tightened by the allocation LP's λ* when
    the instance is LP-sized.

    ``lp_lower_bound`` prices the graph's edge transfer costs into the
    allocation phase (``repro_torch.core.allocation``), so on network-bound
    instances this denominator *sees the network* — the universal bound
    cannot charge transfers at all (a one-type schedule pays none), which
    is exactly the gap between LP-based allocation bounds and realized
    makespans the two-resource survey points at.  Both terms lower-bound
    every comm-charged schedule, so the max is a valid, tighter
    denominator; oversized or type-infeasible instances fall back to the
    universal bound alone.
    """
    if hasattr(counts, "to_counts"):   # Platform (duck-typed: no sim import)
        counts = counts.to_counts()
    lb = makespan_lower_bound(g, counts)
    if (0 < g.n <= lp_max_n and all(c > 0 for c in counts)
            and np.isfinite(g.proc).all()):
        from .hlp import lp_lower_bound
        lb = max(lb, lp_lower_bound(g, counts))
    return lb
