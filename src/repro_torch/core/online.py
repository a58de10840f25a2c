"""On-line scheduling (paper §4.2): greedy rules R1–R3, ER-LS, EFT, Random.

Tasks arrive one by one in an order respecting the precedences; the scheduler
takes an *irrevocable* (allocation + processor + start time) decision at
arrival, knowing only the tasks seen so far and the committed schedule.

ER-LS (Enhanced Rules – List Scheduling), the paper's contribution:
  Step 1: if p̄_j >= R_{j,gpu} + p_j  -> GPU side
          (R_{j,gpu} = max(τ_gpu, max_{i∈Γ⁻(j)} C_i), τ_gpu = earliest idle GPU)
  Step 2: otherwise rule R2: CPU iff p̄_j/√m <= p_j/√k.
Each task is then scheduled as early as possible on its side.
Competitive ratio: at most 4√(m/k) (Thm 3), at least √(m/k) (Thm 4).

Communication awareness: a task's data-ready time depends on the side it is
committed to — crossing a type boundary on edge (i, j) delays j's data by
``g.comm[i→j]``.  Ready times are therefore computed *per type* (a (Q,)
vector); R_{j,gpu} above uses the GPU entry.  With zero edge costs every
entry coincides and all policies reduce to the paper's semantics.

Moldable tasks: on a graph with speedup curves the CPU-vs-GPU threshold
generalizes to a width-aware rule (``erls_decide_moldable``): each side is
represented by its *efficient* width (the widest slot whose per-unit
efficiency stays above a floor, ``efficient_width``), Step 1 compares the
curve-shrunk times at those widths, and Step 2 becomes R2 over *areas*
(w·p)/√m — so committing a wide slot is charged for all the units it
occupies.  At width 1 every formula reduces symbol-for-symbol to the
paper's rule, and the committed state is the shared
``repro_torch.platform.PoolState`` (width-w commits claim w units atomically).
"""
from __future__ import annotations

import numpy as np

from repro_torch.obs import registry as _obs
from repro_torch.platform import Decision, PoolState, as_decision, as_platform

from .dag import CPU, GPU, TaskGraph
from .listsched import Schedule, list_schedule


# ------------------------------------------------------------------- rules
def rule_r1(pc: float, pg: float, m: int, k: int) -> int:
    return CPU if pc / m <= pg / k else GPU


def rule_r2(pc: float, pg: float, m: int, k: int) -> int:
    return CPU if pc / np.sqrt(m) <= pg / np.sqrt(k) else GPU


def rule_r3(pc: float, pg: float, m: int, k: int) -> int:
    return CPU if pc <= pg else GPU


RULES = {"R1": rule_r1, "R2": rule_r2, "R3": rule_r3}


def erls_decide(pc: float, pg: float, m: int, k: int, r_gpu: float) -> int:
    """The ER-LS allocation decision for one arriving task.

    ``r_gpu`` is the task's earliest possible start on the GPU side
    (max of earliest idle GPU and the task's ready time).  Exposed as a pure
    function so ``repro_torch.sim.adapters`` can drive the identical rule from the
    simulation engine's arrival loop.
    """
    if pc >= r_gpu + pg:                           # Step 1
        return GPU
    return rule_r2(pc, pg, m, k)                   # Step 2


def efficient_width(g: TaskGraph, j: int, pool_size: int,
                    eff_floor: float = 0.5) -> int:
    """The widest slot for task j whose per-unit efficiency
    ``speedup(w)/w`` stays >= ``eff_floor`` (capped by the pool size).

    Efficiency is non-increasing in width (a ``TaskGraph.speedup``
    invariant), so this is the last width above the floor — 1 on a
    curve-free graph.
    """
    if g.speedup is None or pool_size <= 1:
        return 1
    W = min(g.max_width, int(pool_size))
    eff = g.speedup[j, :W] / np.arange(1, W + 1)
    above = np.flatnonzero(eff >= eff_floor - 1e-12)
    return int(above[-1]) + 1 if above.size else 1


def erls_decide_moldable(pc: float, pg: float, m: int, k: int, r_gpu: float,
                         wc: int = 1, wg: int = 1) -> Decision:
    """Width-aware ER-LS decision — the paper's rule over (type, width).

    ``pc``/``pg`` are the *curve-shrunk* times at the candidate widths
    ``wc``/``wg`` (see :func:`efficient_width`), and ``r_gpu`` is the
    earliest time ``wg`` GPUs are simultaneously free (floored at the data
    ready time).  Step 1 compares the shrunk times; Step 2 is R2 over the
    *areas* ``w·p`` each slot occupies.  At ``wc == wg == 1`` this is
    symbol-for-symbol :func:`erls_decide`.
    """
    if pc >= r_gpu + pg:                                       # Step 1
        return Decision(GPU, wg)
    if wc * pc / np.sqrt(m) <= wg * pg / np.sqrt(k):           # Step 2 (R2)
        return Decision(CPU, wc)
    return Decision(GPU, wg)


def decide_erls(g: TaskGraph, j: int, m: int, k: int, ready: np.ndarray,
                state) -> "Decision | int":
    """The complete per-task ER-LS decision against a ``PoolState`` — ONE
    implementation shared by the pure-core online loop and the simulation
    adapter (the ``erls_decide`` pattern, extended to widths): rigid graphs
    take the paper's int-returning rule, moldable graphs the width-aware
    rule at each side's efficient width."""
    if g.speedup is None:
        pc, pg = g.proc[j, CPU], g.proc[j, GPU]
        r_gpu = max(state.earliest_idle(GPU), float(ready[GPU]))
        d = erls_decide(pc, pg, m, k, r_gpu)
        if _obs.enabled():
            _record_erls(j, d, 1, pc, pg, m, k, r_gpu, 1, 1)
        return d
    wc = efficient_width(g, j, m)
    wg = efficient_width(g, j, k)
    r_gpu = max(state.earliest_idle(GPU, wg), float(ready[GPU]))
    pc, pg = g.proc_w(j, CPU, wc), g.proc_w(j, GPU, wg)
    d = erls_decide_moldable(pc, pg, m, k, r_gpu, wc, wg)
    if _obs.enabled():
        _record_erls(j, d.rtype, d.width, pc, pg, m, k, r_gpu, wc, wg)
    return d


def _record_erls(j: int, rtype: int, width: int, pc: float, pg: float,
                 m: int, k: int, r_gpu: float, wc: int, wg: int) -> None:
    """Provenance: which ER-LS rule fired for task ``j``.  Re-derives the
    branch from the same comparisons the decision took — pure observation,
    never consulted by the decision itself."""
    from repro_torch.obs import DecisionRecord
    if pc >= r_gpu + pg:
        rule = "step1:gpu"
    elif wc * pc / np.sqrt(m) <= wg * pg / np.sqrt(k):
        rule = "r2:cpu"
    else:
        rule = "r2:gpu"
    _obs.record_decision(DecisionRecord(
        scheduler="er_ls", task=j, rtype=int(rtype), width=int(width),
        rule=rule))


def decide_eft(g: TaskGraph, j: int, counts, ready: np.ndarray,
               state) -> "Decision | int":
    """The complete per-task EFT decision against a ``PoolState`` — shared
    by ``eft_online`` and the simulation adapter.  Rigid graphs keep the
    historical type-only loop (bit-parity); on moldable graphs every
    (type, width) slot competes, ties toward the smaller processing time."""
    if g.speedup is None:
        best_q, best_f = 0, np.inf
        for q in range(g.num_types):
            p = g.proc[j, q]
            if not np.isfinite(p):
                continue
            f = max(float(ready[q]), state.earliest_idle(q)) + p
            if f < best_f - 1e-12 or (abs(f - best_f) <= 1e-12
                                      and p < g.proc[j, best_q]):
                best_q, best_f = q, f
        return best_q
    best, best_f, best_p = Decision(0), np.inf, np.inf
    for q in range(g.num_types):
        for w in range(1, min(g.max_width, int(counts[q])) + 1):
            p = g.proc_w(j, q, w)
            if not np.isfinite(p):
                continue
            f = max(float(ready[q]), state.earliest_idle(q, w)) + p
            if f < best_f - 1e-12 or (abs(f - best_f) <= 1e-12 and p < best_p):
                best, best_f, best_p = Decision(q, w), f, p
    return best


def _arrival_order(g: TaskGraph, rng: np.random.Generator | None = None) -> np.ndarray:
    """A precedence-respecting arrival order (randomized topo if rng given)."""
    if rng is None:
        return g.topo
    # Random linear extension: Kahn with random tie-breaking.
    indeg = np.diff(g.pred_ptr).astype(np.int64).copy()
    avail = list(np.flatnonzero(indeg == 0))
    order = np.empty(g.n, dtype=np.int32)
    for i in range(g.n):
        j = avail.pop(int(rng.integers(len(avail))))
        order[i] = j
        for v in g.succs(int(j)):
            indeg[v] -= 1
            if indeg[v] == 0:
                avail.append(int(v))
    return order


# The committed-schedule view is the shared ``repro_torch.platform.PoolState`` —
# the same heaps the simulation engine, streams engine and dispatcher use.


def ready_per_type(g: TaskGraph, j: int, finish: np.ndarray,
                   alloc: np.ndarray, num_types: int,
                   floor: float = 0.0) -> np.ndarray:
    """(Q,) earliest data-ready time of task ``j`` per candidate type.

    Entry q is ``max_i finish[i] + comm[i→j]·[alloc[i] != q]`` over j's
    already-committed predecessors (all of them, in arrival order), floored
    at ``floor`` (the release time).  Shared by ``repro_torch.sim.engine`` so the
    scalar engine and the pure-core online loop charge identical delays.
    """
    p0, p1 = g.pred_ptr[j], g.pred_ptr[j + 1]
    ready = np.full(num_types, floor)
    if p1 > p0:
        pi = g.pred_idx[p0:p1]
        fin = finish[pi]
        if g.has_comm:
            pc = g.comm[g.pred_eid[p0:p1]]
            for q in range(num_types):
                ready[q] = max(floor, float(
                    np.max(fin + np.where(alloc[pi] != q, pc, 0.0))))
        else:
            ready[:] = max(floor, float(fin.max()))
    return ready


def _run_online(g: TaskGraph, platform, decide, order: np.ndarray) -> Schedule:
    """Drive an online policy; ``decide(j, ready, mach) -> Decision | type``
    sees the pool state and the (Q,) per-type data-ready vector."""
    n = g.n
    Q = platform.num_types
    mach = PoolState(platform)
    alloc = np.zeros(n, dtype=np.int32)
    width = np.ones(n, dtype=np.int32)
    proc = np.zeros(n, dtype=np.int32)
    start = np.zeros(n); finish = np.zeros(n)
    units: list[tuple[int, ...]] = [()] * n
    wide = False
    for j in order:
        j = int(j)
        ready = ready_per_type(g, j, finish, alloc, Q)
        d = as_decision(decide(j, ready, mach))
        alloc[j], width[j] = d.rtype, d.width
        wide = wide or d.width > 1
        units[j], start[j], finish[j] = mach.commit_wide(
            d.rtype, ready[d.rtype], g.proc_w(j, d.rtype, d.width), d.width)
        proc[j] = units[j][0]
    if not wide:
        return Schedule(alloc=alloc, proc=proc, start=start, finish=finish)
    return Schedule(alloc=alloc, proc=proc, start=start, finish=finish,
                    width=width, procs=tuple(units))


# ------------------------------------------------------------------ policies
def er_ls(g: TaskGraph, machine, order: np.ndarray | None = None) -> Schedule:
    """The paper's on-line algorithm (enhanced rules + list scheduling) —
    width-aware on moldable graphs via :func:`decide_erls`."""
    platform = as_platform(machine)
    m, k = platform.counts[CPU], platform.counts[GPU]

    def decide(j: int, ready: np.ndarray, mach: PoolState):
        return decide_erls(g, j, m, k, ready, mach)

    return _run_online(g, platform, decide,
                       g.topo if order is None else order)


def eft_online(g: TaskGraph, machine, order: np.ndarray | None = None) -> Schedule:
    """Baseline: commit each arriving task to the slot minimizing its EFT
    (every (type, width) slot competes on a moldable graph)."""
    platform = as_platform(machine)

    def decide(j: int, ready: np.ndarray, mach: PoolState):
        return decide_eft(g, j, platform.counts, ready, mach)

    return _run_online(g, platform, decide,
                       g.topo if order is None else order)


def greedy_online(g: TaskGraph, machine,
                  rule: str = "R3", order: np.ndarray | None = None) -> Schedule:
    """Baseline: allocation by a processing-time-only rule, then List Scheduling."""
    platform = as_platform(machine)
    m, k = platform.counts[CPU], platform.counts[GPU]
    fn = RULES[rule]
    alloc = np.asarray([fn(g.proc[j, CPU], g.proc[j, GPU], m, k) for j in range(g.n)],
                       dtype=np.int32)
    return list_schedule(g, platform, alloc)


def random_online(g: TaskGraph, machine, seed: int = 0) -> Schedule:
    """Baseline: uniformly random side per task, then List Scheduling."""
    platform = as_platform(machine)
    rng = np.random.default_rng(seed)
    alloc = rng.integers(0, g.num_types, size=g.n).astype(np.int32)
    return list_schedule(g, platform, alloc)
