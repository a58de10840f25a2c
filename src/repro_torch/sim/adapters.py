"""Scheduler adapters: every algorithm in ``repro_torch.core`` behind one protocol.

Static (plan-first) adapters run the paper's two-phase pipeline on the
*estimated* ``proc`` matrix and hand the engine a full ``Plan``; the engine
then replays it under realized runtimes.  Arrival-driven adapters implement
``on_task_arrival`` and decide irrevocably per task, exactly the paper's
§4.2 model.

Registry (``ADAPTERS`` / ``make_scheduler``):

  static:   ``hlp_est``, ``hlp_ols``, ``hlp_jax_ols``, ``heft``,
            ``heft_nocomm`` (plans ignoring edge costs — the engine still
            charges them at replay; baseline for communication awareness),
            ``cahlp_ols``/``camhlp_ols`` (comm-aware allocation: the
            HLP/MHLP LP prices edge transfer costs before scheduling;
            bit-identical to ``hlp_ols`` at zero comm),
            ``mhlp_ols`` (width-indexed moldable HLP + width-aware OLS;
            on a curve-free graph it routes through the exact hlp_ols
            path), ``bruteforce`` (branch-and-bound oracle, n ≤ ~10),
            ``evo``/``evo_camhlp`` (population-based plan search,
            ``repro_torch.search``, scored on the card)
  online:   ``er_ls``, ``eft``, ``greedy_r1``/``greedy_r2``/``greedy_r3``,
            ``random``

Arrival-driven adapters receive ``ready`` as the (Q,) per-type data-ready
vector (cross-type edges pay ``g.comm``) and return a
``repro_torch.platform.Decision`` — or a bare type int, read as width 1 (the
deprecated pre-v2 protocol the engine still accepts).  With zero edge costs
and no speedup curves everything coincides with the paper's semantics.

All adapters are stateless between ``simulate`` calls except ``random``,
which derives its stream from the adapter seed so campaigns stay
reproducible.

This is the port's copy of the JAX package's ``repro.sim.adapters``, with
every one of its adapters.  ``hlp_jax_ols`` keeps the reference's name; its
first-order LP (``repro_torch.core.hlp_jax``) is one launch of the
``hlp_fo`` kernel on the card.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bruteforce import brute_force_schedule
from repro_torch.core.dag import CPU, GPU, TaskGraph
from repro_torch.core.hlp import solve_hlp, solve_mhlp, solve_qhlp
from repro_torch.core.listsched import heft, hlp_est, hlp_ols
from repro_torch.core.online import RULES, decide_eft, decide_erls
from repro_torch.obs import registry as _obs

from .engine import Machine, MachineState, Plan


def _record_lp_provenance(name: str, g: TaskGraph, machine, sol, *,
                          comm_aware: bool = False,
                          contention: bool = False) -> None:
    """Provenance capture for LP-backed allocators: one
    ``repro_torch.obs.DecisionRecord`` per task — the fractional row, the
    tie-break the rounding took, and the comm price paid (realized crossing
    cost) vs priced (what the LP objective saw).  No-op unless the obs
    registry is enabled; reads the solution only, never alters it."""
    if not _obs.enabled():
        return
    from repro_torch.core.allocation import expected_link_load, task_comm_price
    from repro_torch.obs import DecisionRecord

    paid = task_comm_price(g, sol.alloc, direction="both")
    if comm_aware and g.num_edges:
        priced_comm = np.asarray(g.comm, dtype=np.float64)
        if contention:
            priced_comm = priced_comm * expected_link_load(g, machine.counts)
        priced = task_comm_price(g, sol.alloc, comm=priced_comm,
                                 direction="both")
    else:
        priced = np.zeros(g.n)
    x = np.asarray(sol.x_frac)
    for j in range(g.n):
        if x.ndim == 1:   # hybrid LP: x[j] = CPU fraction
            xj = (round(float(x[j]), 6),)
            tb = "threshold:cpu" if x[j] >= 0.5 else "threshold:gpu"
        else:             # choice-grid LP: argmax row, ties -> fastest
            row = np.asarray(x[j]).ravel()
            cand = np.flatnonzero(row >= row.max() - 1e-9)
            xj = tuple(round(float(v), 6) for v in row)
            tb = "argmax" if cand.size == 1 else "argmax_tie:min_time"
        _obs.record_decision(DecisionRecord(
            scheduler=name, task=j, rtype=int(sol.alloc[j]),
            width=int(sol.width[j]) if sol.width is not None else 1,
            x_frac=xj, tie_break=tb,
            comm_price=float(paid[j]), priced_comm=float(priced[j])))


class StaticScheduler:
    """Base: wrap a ``(g, machine) -> Schedule`` solver into the protocol.

    ``plan_pool`` routes the adapter's ``allocate`` in the pipelined
    executor (``repro_torch.sim.pipeline``):
    ``"process"`` for the HiGHS/LP-heavy solvers that hold the GIL,
    ``"thread"`` for ones that must stay in-process.  ``cacheable = False`` opts an adapter
    out of the content-addressed plan cache."""

    name = "static"
    plan_pool = "thread"
    cacheable = True

    def _solve(self, g: TaskGraph, machine: Machine):
        raise NotImplementedError

    def allocate(self, g: TaskGraph, machine: Machine) -> Plan:
        return Plan.from_schedule(self._solve(g, machine), machine)

    def on_task_arrival(self, j: int, ready: float, state: MachineState) -> int:
        raise RuntimeError(f"{self.name} is a static scheduler")


class HLPESTScheduler(StaticScheduler):
    """Paper §3/§5: HLP/QHLP allocation LP + EST list scheduling."""

    name = "hlp_est"
    plan_pool = "process"   # scipy/HiGHS LP solve dominates

    def _allocate_lp(self, g: TaskGraph, machine: Machine) -> np.ndarray:
        counts = machine.counts
        sol = (solve_hlp(g, counts[0], counts[1]) if g.num_types == 2
               else solve_qhlp(g, machine))
        _record_lp_provenance(self.name, g, machine, sol)
        return sol.alloc

    def _solve(self, g, machine):
        return hlp_est(g, machine, self._allocate_lp(g, machine))


class HLPOLSScheduler(HLPESTScheduler):
    """Paper §4.1: HLP/QHLP allocation + Ordered List Scheduling."""

    name = "hlp_ols"

    def _solve(self, g, machine):
        return hlp_ols(g, machine, self._allocate_lp(g, machine))


class HLPJaxOLSScheduler(HLPOLSScheduler):
    """Beyond-paper: the first-order HLP solver + OLS (Q=2 only).

    ``device`` is where the solve runs: ``"cuda"``, one launch of the
    ``hlp_fo`` kernel; ``"cpu"``, its plain version.  It is part of the plan
    cache's key, since the two agree to rounding, not to the bit."""

    name = "hlp_jax_ols"
    plan_pool = "thread"    # launches on the card: stays in-process

    def __init__(self, iters: int = 300, seed: int = 0,
                 device: str = "cuda"):
        self.iters, self.seed = iters, seed
        self.device = str(device)

    def _allocate_lp(self, g, machine):
        from repro_torch.core.hlp_jax import solve_hlp_jax

        if g.num_types != 2:
            raise ValueError("hlp_jax_ols requires Q=2")
        sol = solve_hlp_jax(g, machine.counts[0], machine.counts[1],
                            iters=self.iters, seed=self.seed,
                            device=self.device)
        _record_lp_provenance(self.name, g, machine, sol)
        return sol.alloc


class CommAwareHLPScheduler(StaticScheduler):
    """Comm-aware two-phase pipeline (CAHLP-OLS): the allocation LP prices
    per-edge transfer costs — crossing terms on the choice grid, see
    ``repro_torch.core.allocation`` — so the *allocation*, not just the
    scheduling phase, sees the network; then OLS with the comm tie-break.

    On a zero-``comm`` graph the priced LP is byte-identical to the
    oblivious one, so this adapter reproduces ``hlp_ols`` schedule-hash-
    for-schedule-hash (golden-tested).

    ``contention=True`` scales each edge's LP price by its expected link
    load (``repro_torch.core.allocation.expected_link_load``) — the allocation
    then anticipates a *contended* network (``maxmin_fair``), not just a
    fixed-latency one."""

    name = "cahlp_ols"
    plan_pool = "process"

    def __init__(self, contention: bool = False):
        self.contention = contention

    def _allocate_lp(self, g: TaskGraph, machine: Machine) -> np.ndarray:
        counts = machine.counts
        sol = (solve_hlp(g, counts[0], counts[1], comm_aware=True,
                         contention=self.contention) if g.num_types == 2
               else solve_qhlp(g, machine, comm_aware=True,
                               contention=self.contention))
        _record_lp_provenance(self.name, g, machine, sol, comm_aware=True,
                              contention=self.contention)
        return sol.alloc

    def _solve(self, g, machine):
        return hlp_ols(g, machine, self._allocate_lp(g, machine),
                       comm_tiebreak=True)


class CommAwareMoldableScheduler(StaticScheduler):
    """CAMHLP-OLS: the width-indexed MHLP with per-edge comm terms hung on
    the (type, width) choice grid, then width-aware OLS with the comm
    tie-break.  Width-1 graphs route through the exact CAHLP path (so at
    ``ccr=0`` this is ``hlp_ols`` bit-for-bit, like ``mhlp_ols``).

    ``contention=True`` scales the LP's edge prices by expected link load
    (forwarded to the width-1 CAHLP route too)."""

    name = "camhlp_ols"
    plan_pool = "process"

    def __init__(self, contention: bool = False):
        self.contention = contention

    def _solve(self, g, machine):
        if g.max_width == 1:
            return CommAwareHLPScheduler(
                contention=self.contention)._solve(g, machine)
        sol = solve_mhlp(g, machine, comm_aware=True,
                         contention=self.contention)
        _record_lp_provenance(self.name, g, machine, sol, comm_aware=True,
                              contention=self.contention)
        return hlp_ols(g, machine, sol.alloc, sol.width, comm_tiebreak=True)


class MoldableHLPScheduler(StaticScheduler):
    """Width-indexed MHLP allocation + width-aware OLS — the moldable
    two-phase pipeline.

    On a curve-free (width-1) graph it routes through the exact classic
    path (``solve_hlp``/``solve_qhlp`` + ``hlp_ols``) so the redesign's
    golden bit-parity holds; on a moldable graph the LP chooses each task's
    ``(type, width)`` decision and the width-aware list scheduler inserts
    width-w tasks across w units of their pool.
    """

    name = "mhlp_ols"
    plan_pool = "process"

    def _solve(self, g, machine):
        if g.max_width == 1:
            return HLPOLSScheduler()._solve(g, machine)
        sol = solve_mhlp(g, machine)
        _record_lp_provenance(self.name, g, machine, sol)
        return hlp_ols(g, machine, sol.alloc, sol.width)


class HEFTScheduler(StaticScheduler):
    """Insertion-based HEFT baseline (single phase, communication-aware)."""

    name = "heft"

    def _solve(self, g, machine):
        return heft(g, machine)


class HEFTObliviousScheduler(StaticScheduler):
    """HEFT that *plans* as if transfers were free (the paper's model).

    The engine still delays data on cross-type edges at replay, so on
    communication-bound scenarios this measures exactly what ignoring the
    network costs."""

    name = "heft_nocomm"

    def _solve(self, g, machine):
        return heft(g, machine, comm_aware=False)


class BruteForceScheduler(StaticScheduler):
    """Branch-and-bound optimum — the oracle adapter for small n (≤ ~10)."""

    name = "bruteforce"
    plan_pool = "process"   # pure-python branch and bound

    def _solve(self, g, machine):
        return brute_force_schedule(g, machine)


# ----------------------------------------------------------- arrival-driven
class OnlineScheduler:
    """Base for arrival-driven policies: no static plan."""

    name = "online"
    plan_pool = "thread"
    cacheable = False   # allocate() binds state and returns None

    def allocate(self, g: TaskGraph, machine: Machine) -> None:
        self._g = g
        self._machine = machine
        return None

    def on_task_arrival(self, j: int, ready: float, state: MachineState) -> int:
        raise NotImplementedError


class ERLSScheduler(OnlineScheduler):
    """Paper §4.2: Enhanced Rules + List Scheduling (4·√(m/k)-competitive).

    The per-task decision *is* ``repro_torch.core.online.decide_erls`` — the same
    function the pure-core loop drives (rigid graphs: the historical int
    rule; moldable graphs: the width-aware rule at each side's efficient
    width), so the two paths cannot desynchronize."""

    name = "er_ls"

    def on_task_arrival(self, j, ready, state):
        machine = self._machine
        return decide_erls(self._g, j, machine.counts[CPU],
                           machine.counts[GPU], ready, state)


class EFTScheduler(OnlineScheduler):
    """Commit each arriving task to the slot minimizing its estimated EFT —
    the shared ``repro_torch.core.online.decide_eft`` rule (every (type, width)
    slot competes on a moldable graph)."""

    name = "eft"

    def on_task_arrival(self, j, ready, state):
        return decide_eft(self._g, j, self._machine.counts, ready, state)


class GreedyRuleScheduler(OnlineScheduler):
    """Processing-time-only rules R1–R3 (paper §4.2 baselines, Q=2)."""

    def __init__(self, rule: str = "R2"):
        self.rule = RULES[rule]
        self.name = f"greedy_{rule.lower()}"

    def on_task_arrival(self, j, ready, state):
        g, machine = self._g, self._machine
        return self.rule(g.proc[j, CPU], g.proc[j, GPU],
                         machine.counts[CPU], machine.counts[GPU])


class RandomScheduler(OnlineScheduler):
    """Uniformly random type per task (seeded at allocate time)."""

    name = "random"

    def __init__(self, seed: int = 0):
        self.seed = seed

    def allocate(self, g, machine):
        super().allocate(g, machine)
        self._rng = np.random.default_rng(self.seed)
        return None

    def on_task_arrival(self, j, ready, state):
        return int(self._rng.integers(0, self._g.num_types))


class EvoScheduler:
    """Population-based plan search (``repro_torch.search.evolve_plan``) as
    an adapter: evolves (allocation, priority) genomes whose generations
    score as one fixed-shape batch through the bucketed replay, seeded with
    the LP/HEFT/ER-LS plans so the result is anytime-no-worse than the best
    of them.  Defaults are sized for adapter use (small budget); campaigns
    build their own ``SearchConfig``.

    Construction kwargs forward to ``SearchConfig`` (``method``,
    ``pop_size``, ``generations``, ...); ``seed`` feeds the search rng and
    ``device`` is where each generation is scored (``"cuda"``: the replay
    kernel; ``"cpu"``: its plain version — the plans are bit-identical, so
    the device is not part of the plan cache's key)."""

    name = "evo"
    plan_pool = "thread"    # scores on the card: stays in-process
    cacheable = True        # deterministic given (config, seed)
    _comm_aware = False

    def __init__(self, seed: int = 0, device: str = "cuda", **cfg):
        from repro_torch.search import SearchConfig
        cfg.setdefault("pop_size", 16)
        cfg.setdefault("generations", 5)
        cfg.setdefault("comm_aware", self._comm_aware)
        self.seed = seed
        self.config = SearchConfig(**cfg)
        self._device = device

    def allocate(self, g: TaskGraph, machine: Machine) -> Plan:
        from repro_torch.search import evolve_plan
        return evolve_plan(g, machine, self.config, seed=self.seed,
                           device=self._device).plan

    def on_task_arrival(self, j: int, ready: float, state: MachineState):
        raise RuntimeError(f"{self.name} is a static scheduler")


class EvoCommAwareScheduler(EvoScheduler):
    """``evo`` with comm/moldable-aware seeding and ordering: generation 0
    starts from the comm-priced LP (CAHLP/CAMHLP rounding) and every genome
    replays with the comm tie-break — the search-side counterpart of
    ``camhlp_ols``."""

    name = "evo_camhlp"
    _comm_aware = True


class FrozenPlanScheduler:
    """Adapter around a precomputed ``Plan`` — lets any plan (including one
    materialized from an arrival-driven policy via ``plan_for``) ride the
    batch path's ``allocate``-then-replay pipeline."""

    plan_pool = "thread"
    cacheable = False   # the plan's provenance is not in (name, config)

    def __init__(self, plan: Plan, name: str = "frozen"):
        self._plan, self.name = plan, name

    def allocate(self, g: TaskGraph, machine: Machine) -> Plan:
        return self._plan

    def on_task_arrival(self, j: int, ready, state: MachineState):
        if self._plan.width is None:
            return int(self._plan.alloc[j])
        return self._plan.decision(j)


def plan_for(name: str, g: TaskGraph, machine: Machine, **kw) -> Plan:
    """A static ``Plan`` from *any* adapter.

    Static adapters allocate directly; arrival-driven ones (er_ls, eft,
    greedy_*, random) are rolled out once on an idle machine through the
    scalar engine and the committed schedule becomes the plan — which is
    what lets an online policy's decisions ride the batch path's
    replay-under-noise evaluation (wrap the result in
    ``FrozenPlanScheduler`` for ``sweep_suite_makespans``).  For plans
    conditioned on a *busy* machine, see the JAX package's
    ``repro.streams.policy.conditioned_plan``.
    """
    sched = make_scheduler(name, **kw)
    plan = sched.allocate(g, machine)
    if plan is None:
        from .engine import simulate
        plan = Plan.from_schedule(
            simulate(g, machine, sched, validate=False).schedule, machine)
    return plan


ADAPTERS = {
    "hlp_est": HLPESTScheduler,
    "hlp_ols": HLPOLSScheduler,
    "hlp_jax_ols": HLPJaxOLSScheduler,
    "cahlp_ols": CommAwareHLPScheduler,
    "camhlp_ols": CommAwareMoldableScheduler,
    "mhlp_ols": MoldableHLPScheduler,
    "heft": HEFTScheduler,
    "heft_nocomm": HEFTObliviousScheduler,
    "er_ls": ERLSScheduler,
    "eft": EFTScheduler,
    "greedy_r1": lambda: GreedyRuleScheduler("R1"),
    "greedy_r2": lambda: GreedyRuleScheduler("R2"),
    "greedy_r3": lambda: GreedyRuleScheduler("R3"),
    "random": RandomScheduler,
    "bruteforce": BruteForceScheduler,
    "evo": EvoScheduler,
    "evo_camhlp": EvoCommAwareScheduler,
}


def make_scheduler(name: str, **kw):
    if name not in ADAPTERS:
        raise ValueError(f"unknown scheduler {name!r}; have {sorted(ADAPTERS)}")
    return ADAPTERS[name](**kw) if kw else ADAPTERS[name]()
