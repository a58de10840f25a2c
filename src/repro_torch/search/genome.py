"""Plan genomes: (allocation vector, priority permutation) and operators —
the port of the JAX package's ``repro.search.genome`` (host code only).

A *genome* encodes one static plan as evolution-friendly arrays:

  * ``types``  — (n,) resource type per task (the mapping genome of the
    ESTEE genetic scheduler);
  * ``widths`` — (n,) units each task occupies (1 everywhere on rigid
    graphs; on moldable graphs any ``Decision``-legal width);
  * ``perm``   — (n,) priority permutation: a *topological* order of the
    DAG.  Earlier in the permutation = higher list-scheduling priority.

The phenotype is produced by the same typed list scheduler every LP-backed
adapter uses (:func:`repro_torch.core.listsched.list_schedule` with the
permutation as the priority vector), so a genome is always a *feasible*
plan and the search space is exactly "every (allocation, order) the paper's
machinery could express".

Operators (pure numpy + a caller-supplied ``np.random.Generator`` — no
deap):

  * :func:`order_crossover` — ESTEE-style OX on the permutation: a prefix
    of parent 1, the remaining tasks in parent 2's relative order.  Both
    parents topological ⇒ the child is topological (property-tested).
  * :func:`alloc_crossover` — two-point crossover on the (type, width)
    mapping.
  * :func:`mutate_alloc` — per-gene type/width resampling within pool
    bounds (``1 ≤ w ≤ min(g.max_width, counts[type])``).
  * :func:`mutate_perm` — precedence-window insertion moves: a task may
    only relocate between its latest predecessor and earliest successor,
    so the permutation stays topological by construction.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.dag import TaskGraph
from repro_torch.core.hlp import solve_hlp, solve_mhlp, solve_qhlp
from repro_torch.core.listsched import comm_tiebreak_key, hlp_ols, list_schedule
from repro_torch.sim.engine import Plan, plan_times


@dataclasses.dataclass(frozen=True)
class Genome:
    """One candidate plan in array form (immutable; hash via :meth:`key`)."""

    types: np.ndarray   # (n,) int32 resource type per task
    widths: np.ndarray  # (n,) int32 units per task (all 1 on rigid graphs)
    perm: np.ndarray    # (n,) int32 topological priority permutation

    def key(self) -> bytes:
        """Content hash key — identical genomes dedup before scoring."""
        return (self.types.astype(np.int32).tobytes()
                + self.widths.astype(np.int32).tobytes()
                + self.perm.astype(np.int32).tobytes())


def width_caps(g: TaskGraph, machine) -> np.ndarray:
    """(Q,) legal width ceiling per resource type:
    ``min(g.max_width, counts[q])``, at least 1."""
    from repro_torch.platform import as_platform

    counts = np.asarray(as_platform(machine, warn=False).to_counts(),
                        dtype=np.int64)
    return np.maximum(1, np.minimum(int(g.max_width), counts))


def is_topo_perm(g: TaskGraph, perm: np.ndarray) -> bool:
    """Every task appears after all of its predecessors."""
    perm = np.asarray(perm)
    if sorted(perm.tolist()) != list(range(g.n)):
        return False
    pos = np.empty(g.n, dtype=np.int64)
    pos[perm] = np.arange(g.n)
    for j in range(g.n):
        p0, p1 = g.pred_ptr[j], g.pred_ptr[j + 1]
        if (pos[g.pred_idx[p0:p1]] >= pos[j]).any():
            return False
    return True


def topo_perm(g: TaskGraph, scores: np.ndarray) -> np.ndarray:
    """Priority-driven topological order: among ready tasks, highest
    ``scores`` first (ties: lowest task id).  Any real-valued score vector
    maps to a valid permutation — how CEM samples the order genome."""
    scores = np.asarray(scores, dtype=np.float64)
    indeg = np.diff(g.pred_ptr).astype(np.int64).copy()
    heap = [(-scores[j], int(j)) for j in np.flatnonzero(indeg == 0)]
    heapq.heapify(heap)
    out = np.empty(g.n, dtype=np.int32)
    for k in range(g.n):
        _, j = heapq.heappop(heap)
        out[k] = j
        s0, s1 = g.succ_ptr[j], g.succ_ptr[j + 1]
        for v in g.succ_idx[s0:s1]:
            indeg[v] -= 1
            if indeg[v] == 0:
                heapq.heappush(heap, (-scores[v], int(v)))
    return out


def random_genome(g: TaskGraph, machine, rng: np.random.Generator) -> Genome:
    """Uniform random genome: types uniform over pools, widths uniform in
    the legal range, permutation a random topological order."""
    caps = width_caps(g, machine)
    types = rng.integers(0, g.num_types, size=g.n).astype(np.int32)
    if g.speedup is None:
        widths = np.ones(g.n, dtype=np.int32)
    else:
        widths = (1 + rng.integers(0, caps[types])).astype(np.int32)
    return Genome(types=types, widths=widths,
                  perm=topo_perm(g, rng.random(g.n)))


# ----------------------------------------------------------------- operators
def order_crossover(pa: np.ndarray, pb: np.ndarray,
                    rng: np.random.Generator) -> np.ndarray:
    """OX: a prefix of ``pa`` up to a random cut, then every remaining task
    in ``pb``'s relative order (the ESTEE genetic scheduler's task-order
    mate, deap-free).  Preserves topological validity: within the prefix
    the order is ``pa``'s, within the suffix ``pb``'s, and no successor can
    land in the prefix while its predecessor waits in the suffix (``pa``
    would have been non-topological)."""
    n = len(pa)
    if n < 2:
        return np.asarray(pa, dtype=np.int32).copy()
    cut = int(rng.integers(1, n))
    head = np.asarray(pa[:cut], dtype=np.int32)
    taken = np.zeros(n, dtype=bool)
    taken[head] = True
    tail = np.asarray([t for t in pb if not taken[t]], dtype=np.int32)
    return np.concatenate([head, tail])


def alloc_crossover(ga: Genome, gb: Genome, rng: np.random.Generator
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Two-point crossover on the (type, width) mapping — both columns swap
    together so a child never inherits a width without its type."""
    n = len(ga.types)
    types, widths = ga.types.copy(), ga.widths.copy()
    if n >= 2:
        i, j = sorted(rng.integers(0, n, size=2).tolist())
        types[i:j + 1] = gb.types[i:j + 1]
        widths[i:j + 1] = gb.widths[i:j + 1]
    return types, widths


def mutate_alloc(g: TaskGraph, machine, types: np.ndarray, widths: np.ndarray,
                 rng: np.random.Generator, indpb: float = 0.1
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Per-gene mapping mutation: with probability ``indpb`` a task
    resamples its type (uniform over pools) and, on moldable graphs, its
    width (uniform in ``[1, min(g.max_width, counts[type])]``).  Widths are
    always re-clamped to the new type's cap, so every mutated gene is a
    legal ``Decision``."""
    caps = width_caps(g, machine)
    types = types.copy()
    widths = widths.copy()
    flip = rng.random(g.n) < indpb
    if flip.any():
        types[flip] = rng.integers(0, g.num_types, size=int(flip.sum()))
        if g.speedup is not None:
            widths[flip] = 1 + rng.integers(0, caps[types[flip]])
    np.minimum(widths, caps[types], out=widths)
    return types.astype(np.int32), widths.astype(np.int32)


def mutate_perm(g: TaskGraph, perm: np.ndarray, rng: np.random.Generator,
                moves: int = 2) -> np.ndarray:
    """Precedence-window insertion: pick a task and move it to a uniform
    position strictly between its latest predecessor and earliest successor
    in the current permutation.  Topological in, topological out."""
    perm = list(np.asarray(perm, dtype=np.int64))
    n = len(perm)
    if n < 2:
        return np.asarray(perm, dtype=np.int32)
    pos = np.empty(n, dtype=np.int64)
    for idx, t in enumerate(perm):
        pos[t] = idx
    for _ in range(moves):
        j = int(rng.integers(0, n))
        p0, p1 = g.pred_ptr[j], g.pred_ptr[j + 1]
        s0, s1 = g.succ_ptr[j], g.succ_ptr[j + 1]
        lo = int(pos[g.pred_idx[p0:p1]].max()) + 1 if p1 > p0 else 0
        hi = int(pos[g.succ_idx[s0:s1]].min()) - 1 if s1 > s0 else n - 1
        if hi <= lo:
            continue
        new = int(rng.integers(lo, hi + 1))
        old = int(pos[j])
        if new == old:
            continue
        perm.pop(old)
        perm.insert(new, j)
        a, b = min(old, new), max(old, new)
        for idx in range(a, b + 1):
            pos[perm[idx]] = idx
    return np.asarray(perm, dtype=np.int32)


# --------------------------------------------------------- genome <-> plan
def genome_to_plan(g: TaskGraph, machine, genome: Genome, *,
                   comm_tiebreak: bool = False) -> Plan:
    """Phenotype: typed list scheduling with the permutation as priority
    (earlier in ``perm`` ⇒ scheduled first among ready tasks)."""
    pr = np.empty(g.n, dtype=np.float64)
    pr[genome.perm] = np.arange(g.n, 0, -1, dtype=np.float64)
    tb = (comm_tiebreak_key(g, genome.types)
          if comm_tiebreak and g.has_comm else None)
    sched = list_schedule(g, machine, genome.types, priority=pr,
                          width=(genome.widths if g.speedup is not None
                                 else None),
                          tie_break=tb)
    return Plan.from_schedule(sched, machine)


def plan_start_times(g: TaskGraph, plan: Plan) -> np.ndarray:
    """(n,) clean (noise-free) start times of a plan's replay — the same
    augmented-DAG recurrence the batch evaluator scans, in numpy."""
    from repro_torch.sim.batch import _plan_arrays

    order, pred, delay, _ = _plan_arrays(g, plan)
    t = plan_times(g, plan, g.proc)
    start = np.zeros(g.n)
    finish = np.zeros(g.n)
    for j in order:
        m = pred[j] >= 0
        s = float((finish[pred[j][m]] + delay[j][m]).max()) if m.any() else 0.0
        start[j] = s
        finish[j] = s + t[j]
    return start


def plan_to_genome(g: TaskGraph, machine, plan: Plan) -> Genome:
    """Encode an existing plan (an LP rounding, HEFT, a rolled-out online
    policy) as a genome: its (type, width) columns plus the topological
    permutation that visits tasks in replayed start-time order — what lets
    the heuristics seed generation 0."""
    caps = width_caps(g, machine)
    types = np.asarray(plan.alloc, dtype=np.int32).copy()
    widths = (np.ones(g.n, dtype=np.int32) if plan.width is None
              else np.asarray(plan.width, dtype=np.int32).copy())
    np.minimum(widths, caps[types], out=widths)
    return Genome(types=types, widths=widths,
                  perm=topo_perm(g, -plan_start_times(g, plan)))


# ----------------------------------------------------------------- seeding
def lp_seed_plan(g: TaskGraph, machine, *, comm_aware: bool = False) -> Plan:
    """The canonical-rounded LP allocation + OLS — the paper's pipeline
    with the deterministic tie-break, as a seed plan."""
    counts = list(machine.counts)
    tb = comm_aware and g.has_comm
    if g.max_width > 1:
        sol = solve_mhlp(g, machine, canonical=True, comm_aware=comm_aware)
        sched = hlp_ols(g, machine, sol.alloc, sol.width, comm_tiebreak=tb)
    elif g.num_types == 2:
        sol = solve_hlp(g, counts[0], counts[1], canonical=True,
                        comm_aware=comm_aware)
        sched = hlp_ols(g, machine, sol.alloc, comm_tiebreak=tb)
    else:
        sol = solve_qhlp(g, machine, comm_aware=comm_aware)
        sched = hlp_ols(g, machine, sol.alloc, comm_tiebreak=tb)
    return Plan.from_schedule(sched, machine)


def seed_plans(g: TaskGraph, machine, *, comm_aware: bool = False,
               adapters: tuple[str, ...] | None = None) -> dict[str, Plan]:
    """The generation-0 incumbents: the canonical-rounded LP pipeline plus
    HEFT and ER-LS (rolled out once via ``plan_for``) — or any explicit
    adapter list.  The search scores these *plans* alongside the genome
    population, so its anytime best can never be worse than the best
    existing heuristic.

    Every builder here is deterministic given (g, machine, config), so the
    solves route through the content-addressed plan cache
    (:func:`repro_torch.sim.pipeline.cached_solve`): a campaign sweeping many
    search seeds over the same scenario pays for each LP solve and
    heuristic rollout once."""
    from repro_torch.sim.adapters import plan_for
    from repro_torch.sim.pipeline import cached_solve

    if adapters is not None:
        return {name: cached_solve(f"seed.{name}", g, machine,
                                   lambda name=name: plan_for(name, g, machine))
                for name in adapters}
    return {"lp": cached_solve("seed.lp", g, machine,
                               lambda: lp_seed_plan(g, machine,
                                                    comm_aware=comm_aware),
                               extra=(comm_aware,)),
            "heft": cached_solve("seed.heft", g, machine,
                                 lambda: plan_for("heft", g, machine)),
            "er_ls": cached_solve("seed.er_ls", g, machine,
                                  lambda: plan_for("er_ls", g, machine))}
