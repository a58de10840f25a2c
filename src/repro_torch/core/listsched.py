"""Scheduling-phase policies: List Scheduling, EST, OLS, HEFT — plus validation.

All schedulers operate on a ``TaskGraph`` and a ``repro_torch.platform.Platform``
of typed processor pools (the historical bare ``counts`` list is still
accepted through the :func:`repro_torch.platform.as_platform` deprecation shim).
They return a ``Schedule`` with per-task (type, processors, start, finish)
that is validated in the tests against the feasibility invariants
(precedence + per-processor non-overlap + width capacity).

Semantics follow the paper:

* ``list_schedule``     — Graham List Scheduling adapted to typed resources and a
  fixed allocation: whenever a processor of type q is idle and a ready task
  allocated to q exists, start the highest-priority one (event-driven, so no
  artificial idling).  HLP-EST uses arbitrary (natural-order) priority; HLP-OLS
  uses the post-rounding critical-path rank (paper §4.1).
* ``heft``              — insertion-based HEFT (Topcuoglu et al.).  With zero edge
  costs it uses the paper's simplified rank (no communication):
  rank_j = avg_j + max_{i∈succ} rank_i, avg_j = Σ_q m_q p_{j,q} / Σ_q m_q;
  each task goes to the (processor, gap) minimizing its finish time.  When the
  graph carries transfer costs (``g.comm``) the rank adds the *expected*
  cross-type cost per edge and the insertion phase charges ``comm[i→j]``
  whenever the candidate type differs from the predecessor's — the full
  communication-aware HEFT of Topcuoglu et al., which the paper's model
  omits.  Pass ``comm_aware=False`` to plan obliviously (the engine still
  charges transfers at replay; useful as a baseline).

Moldable (multi-width) tasks: when the graph carries speedup curves
(``g.speedup``), a per-task ``width`` vector turns every decision into the
``(type, width)`` pair of ``repro_torch.platform.Decision`` — a width-w task
occupies the w earliest-simultaneously-idle units of its pool and shrinks by
its curve.  ``heft`` additionally searches candidate widths itself
(width-1 slots keep the classic insertion/backfilling; wider slots are
committed append-only across their units).  With ``width=None`` — or on a
curve-free graph — every routine below runs the *identical* width-1 code
path, which the golden bit-parity suite pins byte-for-byte.

All ready-time computations below charge ``g.comm[e]`` on an edge whose
endpoints are committed to different resource types; with ``g.comm == 0``
(the default) everything reduces exactly to the paper's semantics.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.platform import Platform, as_platform

from .dag import TaskGraph


@dataclasses.dataclass
class Schedule:
    alloc: np.ndarray    # (n,) resource type per task
    proc: np.ndarray     # (n,) first processor index *within its type*
    start: np.ndarray    # (n,)
    finish: np.ndarray   # (n,)
    width: np.ndarray | None = None   # (n,) units occupied; None = all 1
    procs: tuple[tuple[int, ...], ...] | None = None  # full unit sets when
    #                                                   any width exceeds 1

    @property
    def makespan(self) -> float:
        return float(self.finish.max()) if self.finish.size else 0.0

    def width_of(self, j: int) -> int:
        return 1 if self.width is None else int(self.width[j])

    def procs_of(self, j: int) -> tuple[int, ...]:
        """All unit indices task j occupies within its pool."""
        if self.procs is not None:
            return self.procs[j]
        return (int(self.proc[j]),)

    def machine_sequences(self, machine) -> dict[tuple[int, int], list[int]]:
        """Per-(type, processor) task sequence ordered by start time.

        This is the *static plan* view of a schedule — what ``repro_torch.sim``
        replays under stochastic runtimes: each processor executes its
        sequence in order, starting each task when its predecessors finish.
        A width-w task appears in all w of its units' sequences.
        """
        p = as_platform(machine, warn=False)
        seqs: dict[tuple[int, int], list[int]] = {
            (q, pid): [] for q in range(p.num_types)
            for pid in range(p.counts[q])}
        for j in np.argsort(self.start, kind="stable"):
            for pid in self.procs_of(int(j)):
                seqs[(int(self.alloc[j]), pid)].append(int(j))
        return seqs

    def validate(self, g: TaskGraph, machine, tol: float = 1e-9,
                 edge_delay: np.ndarray | None = None) -> None:
        """Raise if the schedule is infeasible (used by tests, cheap to keep on).

        ``edge_delay`` overrides the per-edge data-delay *lower bound* the
        precedence check asserts — how network-model runs validate (instant
        transfers bound at 0, contended ones at ``size/bandwidth``); the
        default is the fixed-latency ``g.edge_delays`` array.
        """
        p = as_platform(machine, warn=False)
        counts = p.counts
        t = g.moldable_times(self.alloc, self.width)
        if not np.allclose(self.finish, self.start + t, atol=tol):
            raise AssertionError("finish != start + processing time")
        if (self.start < -tol).any():
            raise AssertionError("negative start time")
        delay = g.edge_delays(self.alloc) if edge_delay is None else edge_delay
        for e, (i, j) in enumerate(g.edges):
            if self.start[j] < self.finish[i] + delay[e] - tol:
                raise AssertionError(f"precedence violated on edge ({i},{j})")
        for q in range(g.num_types):
            sel = np.flatnonzero(self.alloc == q)
            if counts[q] == 0:
                if sel.size:
                    raise AssertionError(f"task allocated to empty type {q}")
                continue
            # Expand width-w tasks to their units, then check pairwise
            # non-overlap per unit exactly as in the width-1 case.
            by_unit: dict[int, list[int]] = {}
            for j in sel:
                units = self.procs_of(int(j))
                if len(units) != self.width_of(int(j)):
                    raise AssertionError(f"task {j}: width/units mismatch")
                for pid in units:
                    if not 0 <= pid < counts[q]:
                        raise AssertionError("processor index out of range")
                    by_unit.setdefault(pid, []).append(int(j))
            for pid, tasks in by_unit.items():
                order = sorted(tasks, key=lambda j: float(self.start[j]))
                for a, b in zip(order[:-1], order[1:]):
                    if self.start[b] < self.finish[a] - tol:
                        raise AssertionError(
                            f"overlap on type {q} proc {pid}: {a},{b}")


# -------------------------------------------------------------- offline: LS
def comm_tiebreak_key(g: TaskGraph, alloc: np.ndarray) -> np.ndarray:
    """(n,) secondary list-scheduling key for comm-aware pipelines: each
    task's total inbound cross-type transfer volume under the allocation —
    the marginal transfer cost its placement actually pays.  Among
    equal-priority ready tasks the one whose inputs already sit on its side
    (smaller key) starts first, so freshly-arrived local data is consumed
    before data still in flight.  All-zero (hence order-neutral) on
    transfer-free instances."""
    key = np.zeros(g.n)
    if g.num_edges:
        np.add.at(key, g.edges[:, 1], g.edge_delays(alloc))
    return key


def list_schedule(g: TaskGraph, machine, alloc: np.ndarray,
                  priority: np.ndarray | None = None,
                  width: np.ndarray | None = None,
                  tie_break: np.ndarray | None = None) -> Schedule:
    """Typed List Scheduling with fixed (type, width) decisions.

    ``priority``: higher runs first among simultaneously-ready tasks
    (default: natural order == the paper's EST policy; pass the OLS rank for
    HLP-OLS).  ``tie_break``: optional secondary key among equal-priority
    ready tasks (lower first; e.g. :func:`comm_tiebreak_key` — an all-zero
    key reproduces the default task-id ordering exactly).  ``width``:
    optional per-task unit counts (moldable tasks); a
    width-w task claims the w earliest-idle units of its pool atomically and
    a task that does not fit the currently idle units is skipped in favor of
    lower-priority ready tasks that do (no artificial idling — the Graham
    rule per unit).  Event-driven: O((n + e) log n) at width 1.
    """
    platform = as_platform(machine)
    counts = platform.to_counts()
    if width is not None:
        width = np.asarray(width, dtype=np.int64)
        if (width > np.asarray(counts)[np.asarray(alloc, dtype=np.int64)]).any():
            raise ValueError("task width exceeds its pool size")
        if (width == 1).all() and g.speedup is None:
            width = None   # rigid instance: take the bit-parity path
    if width is not None:
        return _list_schedule_moldable(g, counts, alloc, width, priority,
                                       tie_break)

    n = g.n
    alloc = np.asarray(alloc, dtype=np.int32)
    pr = np.zeros(n) if priority is None else np.asarray(priority, dtype=np.float64)
    tb = np.zeros(n) if tie_break is None \
        else np.asarray(tie_break, dtype=np.float64)
    times = g.alloc_times(alloc)
    delay = g.edge_delays(alloc)   # transfer delay per edge under this alloc

    indeg = np.diff(g.pred_ptr).astype(np.int64).copy()
    ready_time = np.zeros(n)
    start = np.full(n, -1.0)
    finish = np.full(n, -1.0)
    proc_of = np.full(n, -1, dtype=np.int32)

    # Per-type: heap of (free_time, proc_id); ready PQ of (-priority, tb, j);
    # "becoming ready" heap of (ready_time, -priority, tb, j).
    free = [[(0.0, p) for p in range(counts[q])] for q in range(g.num_types)]
    for h in free:
        heapq.heapify(h)
    ready: list[list] = [[] for _ in range(g.num_types)]
    becoming: list[list] = [[] for _ in range(g.num_types)]

    for j in np.flatnonzero(indeg == 0):
        heapq.heappush(becoming[alloc[j]], (0.0, -pr[j], tb[j], int(j)))

    t = 0.0
    scheduled = 0
    while scheduled < n:
        progressed = True
        while progressed:
            progressed = False
            for q in range(g.num_types):
                while becoming[q] and becoming[q][0][0] <= t + 1e-15:
                    rt, np_, tb_, j = heapq.heappop(becoming[q])
                    heapq.heappush(ready[q], (np_, tb_, j))
                while ready[q] and free[q] and free[q][0][0] <= t + 1e-15:
                    _, _, j = heapq.heappop(ready[q])
                    f, pid = heapq.heappop(free[q])
                    start[j] = t
                    finish[j] = t + times[j]
                    proc_of[j] = pid
                    heapq.heappush(free[q], (finish[j], pid))
                    scheduled += 1
                    progressed = True
                    s0, s1 = g.succ_ptr[j], g.succ_ptr[j + 1]
                    for v, eid in zip(g.succ_idx[s0:s1], g.succ_eid[s0:s1]):
                        ready_time[v] = max(ready_time[v], finish[j] + delay[eid])
                        indeg[v] -= 1
                        if indeg[v] == 0:
                            heapq.heappush(becoming[alloc[v]],
                                           (ready_time[v], -pr[v], tb[v],
                                            int(v)))
        if scheduled == n:
            break
        # Advance to the next event.
        nxt = np.inf
        for q in range(g.num_types):
            if ready[q] and free[q]:
                nxt = min(nxt, free[q][0][0])
            if becoming[q]:
                nxt = min(nxt, becoming[q][0][0])
        if not np.isfinite(nxt) or nxt <= t:
            raise RuntimeError("scheduler stalled (disconnected allocation?)")
        t = nxt
    return Schedule(alloc=alloc, proc=proc_of, start=start, finish=finish)


def _list_schedule_moldable(g: TaskGraph, counts: list[int], alloc: np.ndarray,
                            width: np.ndarray,
                            priority: np.ndarray | None,
                            tie_break: np.ndarray | None = None) -> Schedule:
    """Width-aware LS: same event structure as the width-1 loop, but a task
    claims ``width[j]`` units atomically (skipping it when too few are idle
    *now* lets narrower lower-priority tasks backfill)."""
    n = g.n
    alloc = np.asarray(alloc, dtype=np.int32)
    pr = np.zeros(n) if priority is None else np.asarray(priority, dtype=np.float64)
    tb = np.zeros(n) if tie_break is None \
        else np.asarray(tie_break, dtype=np.float64)
    times = g.moldable_times(alloc, width)
    delay = g.edge_delays(alloc)

    indeg = np.diff(g.pred_ptr).astype(np.int64).copy()
    ready_time = np.zeros(n)
    start = np.full(n, -1.0)
    finish = np.full(n, -1.0)
    proc_of = np.full(n, -1, dtype=np.int32)
    units: list[tuple[int, ...]] = [()] * n

    free = [[(0.0, p) for p in range(counts[q])] for q in range(g.num_types)]
    for h in free:
        heapq.heapify(h)
    ready: list[list] = [[] for _ in range(g.num_types)]
    becoming: list[list] = [[] for _ in range(g.num_types)]

    for j in np.flatnonzero(indeg == 0):
        heapq.heappush(becoming[alloc[j]], (0.0, -pr[j], tb[j], int(j)))

    t = 0.0
    scheduled = 0
    while scheduled < n:
        progressed = True
        while progressed:
            progressed = False
            for q in range(g.num_types):
                while becoming[q] and becoming[q][0][0] <= t + 1e-15:
                    rt, np_, tb_, j = heapq.heappop(becoming[q])
                    heapq.heappush(ready[q], (np_, tb_, j))
                skipped: list[tuple[float, float, int]] = []
                while ready[q] and free[q] and free[q][0][0] <= t + 1e-15:
                    np_, tb_, j = heapq.heappop(ready[q])
                    w = int(width[j])
                    claimed = []
                    while (free[q] and free[q][0][0] <= t + 1e-15
                           and len(claimed) < w):
                        claimed.append(heapq.heappop(free[q]))
                    if len(claimed) < w:      # too few idle units right now
                        for item in claimed:
                            heapq.heappush(free[q], item)
                        skipped.append((np_, tb_, j))
                        continue
                    start[j] = t
                    finish[j] = t + times[j]
                    units[j] = tuple(pid for _, pid in claimed)
                    proc_of[j] = units[j][0]
                    for _, pid in claimed:
                        heapq.heappush(free[q], (finish[j], pid))
                    scheduled += 1
                    progressed = True
                    s0, s1 = g.succ_ptr[j], g.succ_ptr[j + 1]
                    for v, eid in zip(g.succ_idx[s0:s1], g.succ_eid[s0:s1]):
                        ready_time[v] = max(ready_time[v], finish[j] + delay[eid])
                        indeg[v] -= 1
                        if indeg[v] == 0:
                            heapq.heappush(becoming[alloc[v]],
                                           (ready_time[v], -pr[v], tb[v],
                                            int(v)))
                for item in skipped:
                    heapq.heappush(ready[q], item)
        if scheduled == n:
            break
        nxt = np.inf
        for q in range(g.num_types):
            if becoming[q]:
                nxt = min(nxt, becoming[q][0][0])
            if ready[q]:
                # a waiting (possibly wide) task moves when any further unit
                # frees — the earliest free time strictly in the future
                later = [f for f, _ in free[q] if f > t + 1e-15]
                if later:
                    nxt = min(nxt, min(later))
        if not np.isfinite(nxt) or nxt <= t:
            raise RuntimeError("scheduler stalled (width exceeds pool?)")
        t = nxt
    return Schedule(alloc=alloc, proc=proc_of, start=start, finish=finish,
                    width=np.asarray(width, dtype=np.int32),
                    procs=tuple(units))


def ols_rank(g: TaskGraph, alloc: np.ndarray,
             width: np.ndarray | None = None) -> np.ndarray:
    """Paper §4.1: Rank(T_j) = allocated time + max_{succ} Rank — post-rounding.

    With edge costs the rank includes the transfer delay actually paid on
    each cross-type edge; with widths it uses the curve-shrunk (type, width)
    times (the allocation is already fixed here)."""
    return g.upward_rank(g.moldable_times(alloc, width),
                         g.edge_delays(alloc) if g.has_comm else None)


def hlp_est(g: TaskGraph, machine, alloc: np.ndarray,
            width: np.ndarray | None = None) -> Schedule:
    """Scheduling phase of HLP-EST: greedy Earliest Starting Time == untied LS."""
    return list_schedule(g, machine, alloc, priority=None, width=width)


def hlp_ols(g: TaskGraph, machine, alloc: np.ndarray,
            width: np.ndarray | None = None, *,
            comm_tiebreak: bool = False) -> Schedule:
    """Scheduling phase of HLP-OLS: LS ordered by the post-allocation rank.

    ``comm_tiebreak=True`` — the comm-aware allocation pipeline's hook —
    breaks rank ties by each task's marginal inbound transfer cost
    (:func:`comm_tiebreak_key`); on a transfer-free instance the key is
    all-zero and the schedule is bit-identical to the default."""
    tb = comm_tiebreak_key(g, alloc) if comm_tiebreak and g.has_comm else None
    return list_schedule(g, machine, alloc,
                         priority=ols_rank(g, alloc, width), width=width,
                         tie_break=tb)


# ------------------------------------------------------------ offline: HEFT
def heft(g: TaskGraph, machine, *, comm_aware: bool = True) -> Schedule:
    """Insertion-based HEFT for Q typed resource pools (single-phase baseline).

    ``comm_aware=True`` (default) charges ``g.comm`` on cross-type edges in
    both phases: the rank adds the *expected* transfer cost of each edge
    (its cost times the probability that two uniformly drawn processors
    differ in type) and the insertion phase uses the candidate-type data
    ready time.  With zero edge costs both variants coincide with the
    paper's communication-free HEFT, decision for decision.

    On a moldable graph (``g.speedup``) the candidate set per task is every
    ``(type, width)`` pair: width-1 candidates keep the classic per-slot
    insertion, wider candidates are committed append-only across the
    ``width`` least-loaded units (gap alignment across units is not
    searched).  Ties break toward the accelerated pool (paper Thm-1
    convention), then toward the narrower decision (less area).
    """
    platform = as_platform(machine)
    counts = platform.to_counts()
    n, Q = g.n, g.num_types
    total = float(sum(counts))
    avg = (g.proc * np.asarray(counts, dtype=np.float64)).sum(axis=1) / total
    use_comm = comm_aware and g.has_comm
    exp_delay = None
    if use_comm:
        frac = np.asarray(counts, dtype=np.float64) / total
        exp_delay = g.comm * (1.0 - float((frac ** 2).sum()))
    rank = g.upward_rank(avg, exp_delay)
    order = np.argsort(-rank, kind="stable")
    moldable = g.max_width > 1

    # Per (type, proc): sorted list of (start, finish) busy intervals.
    busy: list[list[list[tuple[float, float]]]] = [
        [[] for _ in range(counts[q])] for q in range(Q)]
    start = np.zeros(n); finish = np.zeros(n)
    alloc = np.zeros(n, dtype=np.int32); proc_of = np.zeros(n, dtype=np.int32)
    width_of = np.ones(n, dtype=np.int32)
    units: list[tuple[int, ...]] = [()] * n

    def earliest_fit(intervals: list[tuple[float, float]], r: float, p: float) -> float:
        """Earliest start >= r of a length-p slot (insertion/backfilling)."""
        prev_end = 0.0
        for (s, f) in intervals:
            cand = max(r, prev_end)
            if cand + p <= s + 1e-12:
                return cand
            prev_end = f
        return max(r, prev_end)

    for j in order:
        j = int(j)
        p0, p1 = g.pred_ptr[j], g.pred_ptr[j + 1]
        pi = g.pred_idx[p0:p1]
        pfin = finish[pi] if p1 > p0 else None
        best = (np.inf, 0, 0, 0.0)  # (finish, q, pid, start)
        best_w = (1, (0,))          # (width, unit ids) of the incumbent
        for q in range(Q):
            p = g.proc[j, q]
            if not np.isfinite(p):
                continue
            if pfin is None:
                r = 0.0
            elif use_comm:
                pc = g.comm[g.pred_eid[p0:p1]]
                r = float(np.max(pfin + np.where(alloc[pi] != q, pc, 0.0)))
            else:
                r = float(pfin.max())
            for pid in range(counts[q]):
                s = earliest_fit(busy[q][pid], r, p)
                f = s + p
                # Tie-break toward GPUs (higher q) per the paper's Thm-1 convention.
                if f < best[0] - 1e-12 or (abs(f - best[0]) <= 1e-12 and q > best[1]):
                    best = (f, q, pid, s)
                    best_w = (1, (pid,))
            if moldable:
                # Wider candidates: claim the w least-loaded units append-only.
                ends = sorted((busy[q][pid][-1][1] if busy[q][pid] else 0.0,
                               pid) for pid in range(counts[q]))
                for w in range(2, min(g.max_width, counts[q]) + 1):
                    pw = g.proc_w(j, q, w)
                    s = max(r, ends[w - 1][0])
                    f = s + pw
                    if f < best[0] - 1e-12 or (
                            abs(f - best[0]) <= 1e-12 and q > best[1]):
                        ids = tuple(pid for _, pid in ends[:w])
                        best = (f, q, ids[0], s)
                        best_w = (w, ids)
        f, q, pid, s = best
        w, ids = best_w
        alloc[j], proc_of[j], start[j], finish[j] = q, pid, s, f
        width_of[j] = w
        units[j] = ids
        for u in ids:
            iv = busy[q][u]
            iv.append((s, f))
            iv.sort()
    if not moldable:
        return Schedule(alloc=alloc, proc=proc_of, start=start, finish=finish)
    return Schedule(alloc=alloc, proc=proc_of, start=start, finish=finish,
                    width=width_of, procs=tuple(units))
