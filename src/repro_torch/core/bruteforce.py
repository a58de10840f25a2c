"""Exact optimal makespan via branch-and-bound (test oracle).

Search space: dispatch decisions.  A node picks any *frontier* task (all
predecessors scheduled), a resource type, and starts it as early as possible
on the earliest-free processor of that type.  Within a type the processors
are identical, so earliest-free dispatch is dominant (exchange argument on
the sorted free-time multisets), and branching over every (frontier task,
type) pair reaches an optimal schedule: replay an optimum's tasks in start
order and every dispatch starts no later than it did there.

Transfer costs are honored: a task's ready time on type q is
``max_i finish_i + comm[i→j]·[alloc_i != q]`` over its predecessors, the
same semantics as the engine and the list schedulers.

Pruning: a subtree dies when its admissible lower bound

    max( finished makespan so far,
         max over frontier tasks of  ready + best-type critical tail,
         (Σ processor free times + Σ best-type remaining work) / Σ m_q )

reaches the incumbent, which is seeded with HEFT so the search starts with
a realistic upper bound.  Exact but exponential in the worst case — intended
for the ER-LS competitive-ratio tests at the paper's n ≈ 10 regime
(the previous exhaustive enumeration capped out at n ≤ 7).
"""
from __future__ import annotations

import numpy as np

from .dag import TaskGraph
from .listsched import Schedule, heft

MAX_N = 12  # defensive cap: beyond this the oracle is no longer "seconds"


def _prepare(g: TaskGraph, counts: list[int]):
    """Static data for the search: best-type times, critical tails."""
    if g.n > MAX_N:
        raise ValueError(f"branch-and-bound oracle limited to n <= {MAX_N}")
    tmin = np.min(g.proc, axis=1)
    tmin = np.where(np.isfinite(tmin), tmin, 0.0)
    # best-type critical tail: tail_j = tmin_j + max_{succ} tail  (comm-free,
    # hence admissible: any schedule runs j's longest descendant chain after j)
    tail = np.zeros(g.n)
    for u in g.topo[::-1]:
        s0, s1 = g.succ_ptr[u], g.succ_ptr[u + 1]
        best = tail[g.succ_idx[s0:s1]].max() if s1 > s0 else 0.0
        tail[u] = tmin[u] + best
    return tmin, tail


def _search_bnb(g: TaskGraph, counts: list[int]):
    """Returns (best makespan, alloc, proc, start) via DFS branch-and-bound."""
    n, Q = g.n, g.num_types
    tmin, tail = _prepare(g, counts)
    total_m = float(sum(counts))

    # Incumbent: HEFT gives a feasible (comm-aware) schedule fast.
    from repro_torch.platform import as_platform
    inc = heft(g, as_platform(counts, warn=False))
    best = {"ms": inc.makespan + 1e-12,
            "alloc": np.asarray(inc.alloc, dtype=np.int32).copy(),
            "proc": np.asarray(inc.proc, dtype=np.int32).copy(),
            "start": np.asarray(inc.start, dtype=np.float64).copy()}

    alloc = np.zeros(n, dtype=np.int32)
    proc_of = np.zeros(n, dtype=np.int32)
    start = np.zeros(n)
    finish = np.zeros(n)
    scheduled = np.zeros(n, dtype=bool)
    nsched = 0
    free = [[0.0] * counts[q] for q in range(Q)]
    sum_free = float(sum(counts[q] * 0.0 for q in range(Q)))
    remaining_work = float(tmin.sum())
    indeg = np.diff(g.pred_ptr).astype(np.int64).copy()

    def ready_time(j: int, q: int) -> float:
        p0, p1 = g.pred_ptr[j], g.pred_ptr[j + 1]
        r = 0.0
        for i, eid in zip(g.pred_idx[p0:p1], g.pred_eid[p0:p1]):
            f = finish[i]
            if alloc[i] != q:
                f += g.comm[eid]
            if f > r:
                r = f
        return r

    def dfs(cmax: float):
        nonlocal nsched, sum_free, remaining_work
        if nsched == n:
            if cmax < best["ms"]:
                best["ms"] = cmax
                best["alloc"] = alloc.copy()
                best["proc"] = proc_of.copy()
                best["start"] = start.copy()
            return
        frontier = [j for j in range(n) if not scheduled[j] and indeg[j] == 0]
        # Lower bound: critical tails of the frontier + machine-area bound.
        lb = cmax
        lb = max(lb, (sum_free + remaining_work) / total_m)
        scored = []
        for j in frontier:
            ready = [ready_time(j, q) for q in range(Q)
                     if np.isfinite(g.proc[j, q])]
            if not ready:     # task fits no type at all: subtree infeasible
                return
            r = min(ready)
            lb = max(lb, r + tail[j])
            scored.append((-(r + tail[j]), j))
        if lb >= best["ms"] - 1e-12:
            return
        # Branch most-critical frontier task first, faster type first — finds
        # strong incumbents early so the bound bites.
        scored.sort()
        for _, j in scored:
            types = sorted((q for q in range(Q)
                            if np.isfinite(g.proc[j, q]) and counts[q] > 0),
                           key=lambda q: g.proc[j, q])
            for q in types:
                pid = int(np.argmin(free[q]))
                f0 = free[q][pid]
                s = max(ready_time(j, q), f0)
                f = s + g.proc[j, q]
                if max(cmax, f) >= best["ms"] - 1e-12:
                    continue
                # commit
                alloc[j] = q; proc_of[j] = pid
                start[j] = s; finish[j] = f
                scheduled[j] = True; nsched += 1
                free[q][pid] = f
                sum_free += f - f0
                remaining_work -= tmin[j]
                s0, s1 = g.succ_ptr[j], g.succ_ptr[j + 1]
                # np.*.at handles duplicate (parallel) edges: a successor
                # reached twice must lose two indegree units, not one
                np.subtract.at(indeg, g.succ_idx[s0:s1], 1)
                dfs(max(cmax, f))
                # undo
                np.add.at(indeg, g.succ_idx[s0:s1], 1)
                remaining_work += tmin[j]
                sum_free -= f - f0
                free[q][pid] = f0
                scheduled[j] = False; nsched -= 1

    dfs(0.0)
    return best


def brute_force_opt(g: TaskGraph, machine) -> float:
    """Exact optimal makespan (hybrid or Q-type), comm-aware."""
    from repro_torch.platform import as_platform
    return float(_search_bnb(g, as_platform(machine, warn=False).to_counts())
                 ["ms"])


def brute_force_schedule(g: TaskGraph, machine) -> Schedule:
    """Exact optimal *schedule* (same search, keeps the argmin node).

    Lets ``repro_torch.sim.adapters`` expose the oracle through the same
    ``Scheduler`` protocol as the polynomial algorithms on small instances.
    (Width-1 oracle: the search space stays the paper's rigid model even on
    moldable graphs.)
    """
    from repro_torch.platform import as_platform
    counts = as_platform(machine, warn=False).to_counts()
    if not any(counts) and g.n:
        raise RuntimeError("no feasible schedule (empty machine?)")
    best = _search_bnb(g, counts)
    if not np.isfinite(best["ms"]):
        raise RuntimeError("no feasible schedule (task fits no available type)")
    alloc = best["alloc"]
    t = g.alloc_times(alloc)
    return Schedule(alloc=alloc, proc=best["proc"], start=best["start"],
                    finish=best["start"] + t)
