"""Event-driven scheduler simulation engine.

The engine runs one instance = (``TaskGraph`` of runtime *estimates*,
``Machine`` of typed processor pools, ``Scheduler``) to completion under
*actual* runtimes sampled from a seeded ``NoiseModel``, producing a
validated ``Schedule`` plus a trace of (time, event, task, type, proc)
records.

Scheduler protocol (one interface for offline and online algorithms):

  * ``allocate(g, machine) -> Plan | None`` — called once before the clock
    starts, seeing only the *estimated* ``g.proc``.  Offline algorithms
    return a full static ``Plan`` (type + processor + per-processor order);
    online algorithms return ``None`` and take decisions per arrival.
  * ``on_task_arrival(j, ready, state) -> int`` — called when task ``j``
    arrives (all predecessors committed, release time passed); returns the
    resource type to commit the task to.  The engine then starts it as early
    as possible on that side, the paper's §4.2 semantics.  ``ready`` is a
    (Q,) vector of per-type data-ready times: committing to type q means the
    data arrives at ``ready[q]`` (cross-type edges pay ``g.comm``); with zero
    edge costs every entry is equal.  ``state`` is a ``MachineState`` view of
    the committed schedule.

Execution semantics for a static ``Plan`` (the "replay" model of ESTEE-style
simulators): each processor executes its planned task sequence *in order*;
a task starts when (a) every DAG predecessor has finished *and its data has
arrived* — a cross-type edge (i, j) delivers ``g.comm[i→j]`` time units
after ``finish[i]`` — (b) the previous task in its processor's sequence has
finished, and (c) its release time has passed.  Under zero noise this
reproduces the planning schedule exactly; under noise it measures the
plan's robustness without re-optimizing.

Determinism: ``simulate(..., seed=s)`` is bit-reproducible — the only
randomness is the ``NoiseModel`` stream derived from ``seed``.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.dag import TaskGraph
from repro_torch.core.listsched import Schedule
from repro_torch.obs import registry as _obs
from repro_torch.platform import Platform, PoolState, as_decision


# ------------------------------------------------------------------ machine
class Machine(Platform):
    """Typed processor pools — the simulation-facing name of
    ``repro_torch.platform.Platform`` (kept as a subclass so every existing
    ``Machine(...)`` construction and ``isinstance`` check still holds).

    Pool names now always render: an unnamed construction gets the
    canonical labels (``cpu``/``gpu``/...), so traces and tables from
    ``Machine.hybrid`` and scenario-built machines agree.
    """


# -------------------------------------------------------------------- noise
@dataclasses.dataclass(frozen=True)
class NoiseModel:
    """Multiplicative runtime perturbation of the ``proc`` estimates.

    kind:
      * ``"none"``       — actual == estimate (pure replay).
      * ``"lognormal"``  — actual = estimate · LogNormal(-scale²/2, scale)
                            (unit mean, matching the workload synthesis in
                            ``repro_torch.core.workloads``).
      * ``"uniform"``    — actual = estimate · U[1-scale, 1+scale].

    The same multiplier applies across all types of one task (the noise
    models *misprediction of the task*, not of the machine).
    """

    kind: str = "none"
    scale: float = 0.0

    def __post_init__(self):
        """Reject bad configurations at construction — not mid-simulation
        (a negative lognormal scale or a typo'd kind used to travel until
        numpy failed deep inside ``sample``)."""
        if self.kind not in ("none", "lognormal", "uniform"):
            raise ValueError(f"unknown noise kind {self.kind!r}; "
                             "have 'none', 'lognormal', 'uniform'")
        if not self.scale >= 0.0:
            raise ValueError(f"noise scale must be >= 0, got {self.scale}")
        if self.kind == "uniform" and not self.scale < 1.0:
            raise ValueError("uniform noise needs 0 <= scale < 1, "
                             f"got {self.scale}")

    def sample(self, proc: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.kind == "none" or self.scale == 0.0:
            return proc
        n = proc.shape[0]
        if self.kind == "lognormal":
            mult = rng.lognormal(-0.5 * self.scale ** 2, self.scale, size=n)
        elif self.kind == "uniform":
            if not 0.0 <= self.scale < 1.0:
                raise ValueError("uniform noise needs 0 <= scale < 1")
            mult = rng.uniform(1.0 - self.scale, 1.0 + self.scale, size=n)
        else:
            raise ValueError(f"unknown noise kind {self.kind!r}")
        return proc * mult[:, None]


# --------------------------------------------------------------------- plan
@dataclasses.dataclass(frozen=True)
class Plan:
    """Static scheduling decision: full (type, width) assignment +
    per-processor order.  ``width`` / ``procs`` are ``None`` on rigid
    (width-1) plans — the historical representation, byte-for-byte."""

    alloc: np.ndarray                 # (n,) resource type per task
    proc: np.ndarray                  # (n,) first processor index within type
    sequences: dict[tuple[int, int], list[int]]   # (q, pid) -> ordered tasks
    width: np.ndarray | None = None   # (n,) units per task; None = all 1
    procs: tuple[tuple[int, ...], ...] | None = None  # full unit sets

    def width_of(self, j: int) -> int:
        return 1 if self.width is None else int(self.width[j])

    def decision(self, j: int):
        """Task j's allocation as a first-class ``Decision`` record."""
        from repro_torch.platform import Decision
        return Decision(int(self.alloc[j]), self.width_of(j))

    @staticmethod
    def from_schedule(sched: Schedule, machine) -> "Plan":
        return Plan(alloc=np.asarray(sched.alloc, dtype=np.int32),
                    proc=np.asarray(sched.proc, dtype=np.int32),
                    sequences=sched.machine_sequences(machine),
                    width=(None if sched.width is None
                           else np.asarray(sched.width, dtype=np.int32)),
                    procs=sched.procs)


class MachineState(PoolState):
    """The committed schedule as seen by an online scheduler at arrival time
    — the simulation-facing name of ``repro_torch.platform.PoolState`` (one
    implementation also serves the pure-core online loop, the streams
    engine and the serving dispatcher)."""


def plan_times(g: TaskGraph, plan: Plan, actual: np.ndarray) -> np.ndarray:
    """(n,) realized times of a plan's (type, width) decisions, from an
    (n, Q) realized width-1 times matrix."""
    times = actual[np.arange(g.n), np.asarray(plan.alloc, dtype=np.int64)]
    if plan.width is not None and g.speedup is not None:
        times = times / g.speedup[np.arange(g.n),
                                  np.asarray(plan.width, dtype=np.int64) - 1]
    return times


@runtime_checkable
class Scheduler(Protocol):
    """The unified protocol every adapter in ``repro_torch.sim.adapters`` satisfies."""

    name: str

    def allocate(self, g: TaskGraph, machine: Machine) -> Plan | None:
        """Static plan from estimates, or None for arrival-driven policies."""
        ...

    def on_task_arrival(self, j: int, ready: np.ndarray,
                        state: MachineState) -> "int | object":
        """Allocation for arriving task ``j`` (online policies only): a
        ``repro_torch.platform.Decision`` — or a bare resource-type int, read as
        ``width=1`` (the deprecated pre-v2 protocol).  ``ready`` is the (Q,)
        per-type data-ready vector."""
        ...


# -------------------------------------------------------------------- trace
@dataclasses.dataclass(frozen=True)
class TraceEvent:
    time: float
    event: str          # "start" | "finish" | "job_release" | "job_finish"
    task: int           # task id, or job id for job_* events
    rtype: int
    proc: int
    job: int = -1       # owning job when ``simulate`` is given ``job_of``
    width: int = 1      # units occupied (moldable tasks)


@dataclasses.dataclass(frozen=True)
class SimResult:
    schedule: Schedule
    actual: np.ndarray          # (n, Q) realized processing times
    trace: tuple[TraceEvent, ...]
    scheduler: str
    job_of: np.ndarray | None = None   # (n,) owning job per task, if multi-job

    @property
    def makespan(self) -> float:
        return self.schedule.makespan

    def job_spans(self) -> dict[int, tuple[float, float]]:
        """Per-job (first start, last finish) — the completion events of a
        multi-job run.  Empty when the run carried no ``job_of`` labels."""
        if self.job_of is None:
            return {}
        spans: dict[int, tuple[float, float]] = {}
        for jid in np.unique(self.job_of):
            sel = self.job_of == jid
            spans[int(jid)] = (float(self.schedule.start[sel].min()),
                               float(self.schedule.finish[sel].max()))
        return spans


# ------------------------------------------------------------------- engine
def _execute_plan(g: TaskGraph, plan: Plan, times: np.ndarray,
                  release: np.ndarray,
                  delay: np.ndarray | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Dynamic replay of a static plan under realized task ``times``.

    Data-ready times are delayed by ``g.comm`` on cross-type DAG edges
    (processor-sequence chain edges transfer nothing).  A width-w task
    appears in w per-unit sequences, so it carries one chain dependency per
    claimed unit (width-1 plans have exactly the historical single-chain
    structure).  ``delay`` overrides the per-edge delays (how non-contended
    network models plug in); the default is the historical fixed-latency
    array, byte-for-byte.
    """
    n = g.n
    start = np.zeros(n)
    finish = np.zeros(n)
    if delay is None:
        delay = g.edge_delays(plan.alloc)
    chain_prev: list[list[int]] = [[] for _ in range(n)]
    chain_next: list[list[int]] = [[] for _ in range(n)]
    for seq in plan.sequences.values():
        for a, b in zip(seq[:-1], seq[1:]):
            chain_prev[b].append(a)
            chain_next[a].append(b)
    remaining = np.diff(g.pred_ptr).astype(np.int64) \
        + np.asarray([len(c) for c in chain_prev], dtype=np.int64)
    heap: list[tuple[float, int]] = []
    for j in np.flatnonzero(remaining == 0):
        heapq.heappush(heap, (float(release[j]), int(j)))
    done = 0
    while heap:
        r, j = heapq.heappop(heap)
        start[j] = r
        finish[j] = r + times[j]
        done += 1
        # Each finished task releases one slot per dependency role: one per
        # outgoing DAG edge, plus one per successor slot in its units'
        # sequences (which may be the same task — it then holds two slots).
        for v in list(map(int, g.succs(j))) + chain_next[j]:
            remaining[v] -= 1
            if remaining[v] == 0:
                ready = float(release[v])
                p0, p1 = g.pred_ptr[v], g.pred_ptr[v + 1]
                if p1 > p0:
                    ready = max(ready, float(
                        (finish[g.pred_idx[p0:p1]]
                         + delay[g.pred_eid[p0:p1]]).max()))
                for i in chain_prev[v]:
                    ready = max(ready, float(finish[i]))
                heapq.heappush(heap, (ready, v))
    if done != n:
        raise RuntimeError("plan execution deadlocked (bad plan sequences?)")
    return start, finish


def _execute_plan_network(g: TaskGraph, plan: Plan, times: np.ndarray,
                          release: np.ndarray, network
                          ) -> tuple[np.ndarray, np.ndarray]:
    """Fluid replay of a static plan under a *contended* network model.

    Transfers are first-class in-flight objects: when a task finishes, one
    transfer per distinct ``(source, out_id, destination type)`` crossing
    starts (output caching — a reused output crosses a boundary once, not
    per consumer edge), and all in-flight rates are re-solved with
    :func:`repro_torch.sim.network.maxmin_rates` at every start/finish event.  A
    task starts once its release has passed, its chain predecessors have
    finished, its same-type data has arrived, and every transfer it waits
    on has completed.  With no overlapping transfers every object moves at
    full bandwidth and the schedule coincides with the fixed-latency
    replay (under the default ``size = comm × bandwidth`` objects).
    """
    from .network import maxmin_rates

    n = g.n
    start = np.zeros(n)
    finish = np.zeros(n)
    alloc = np.asarray(plan.alloc, dtype=np.int64)
    bw = float(network.bandwidth)
    sizes = g.data_sizes(bw)
    oids = g.edge_out_ids()
    chain_prev: list[list[int]] = [[] for _ in range(n)]
    chain_next: list[list[int]] = [[] for _ in range(n)]
    for seq in plan.sequences.values():
        for a, b in zip(seq[:-1], seq[1:]):
            chain_prev[b].append(a)
            chain_next[a].append(b)

    # Dependency accounting: +1 release, +1 per chain pred, +1 per same-type
    # DAG pred, +1 per *distinct transfer key* among cross preds (dedup =
    # the caching: several edges shipping one object wait on one transfer).
    need = np.asarray([1 + len(c) for c in chain_prev], dtype=np.int64)
    key_waiters: dict[tuple[int, int, int], list[int]] = {}
    out_keys: dict[int, list[tuple[int, int, int]]] = {}  # src -> its keys
    for j in range(n):
        p0, p1 = g.pred_ptr[j], g.pred_ptr[j + 1]
        mine = set()
        for i, eid in zip(g.pred_idx[p0:p1], g.pred_eid[p0:p1]):
            i, eid = int(i), int(eid)
            if alloc[i] == alloc[j]:
                need[j] += 1
            else:
                key = (i, int(oids[eid]), int(alloc[j]))
                if key not in mine:
                    mine.add(key)
                    need[j] += 1
                    key_waiters.setdefault(key, []).append(j)
                    if key not in out_keys.setdefault(i, []):
                        out_keys[i].append(key)

    seq_id = 0
    heap: list[tuple[float, int, int, int]] = []   # (time, seq, kind, task)
    for j in range(n):                             # kind 0 = release passed
        heapq.heappush(heap, (float(release[j]), seq_id, 0, j))
        seq_id += 1
    # in-flight transfers: key -> [remaining bytes, links]
    active: dict[tuple[int, int, int], list] = {}
    # bytes each key ships = the (shared) object size; take it from any edge
    size_of: dict[tuple[int, int, int], float] = {}
    for j in range(n):
        p0, p1 = g.pred_ptr[j], g.pred_ptr[j + 1]
        for i, eid in zip(g.pred_idx[p0:p1], g.pred_eid[p0:p1]):
            i, eid = int(i), int(eid)
            if alloc[i] != alloc[j]:
                size_of[(i, int(oids[eid]), int(alloc[j]))] = float(sizes[eid])

    started = 0
    t = 0.0

    def resolve(j: int, now: float):
        nonlocal started, seq_id
        need[j] -= 1
        if need[j] == 0:
            start[j] = now
            finish[j] = now + times[j]
            started += 1
            heapq.heappush(heap, (float(finish[j]), seq_id, 1, j))
            seq_id += 1

    def complete_key(key, now: float):
        active.pop(key, None)
        for w in key_waiters.get(key, ()):
            resolve(w, now)

    def on_finish(j: int, now: float):
        for v in list(map(int, g.succs(j))):
            if alloc[v] == alloc[j]:
                resolve(v, now)
        for v in chain_next[j]:
            resolve(v, now)
        for key in out_keys.get(j, ()):
            if size_of[key] <= 0.0:
                complete_key(key, now)
            else:
                active[key] = [size_of[key],
                               network.links_of(int(alloc[j]), key[2])]

    while heap or active:
        rates = None
        t_tr = np.inf
        if active:
            keys = list(active)
            rates = maxmin_rates([active[k][1] for k in keys], bw)
            t_tr = min(t + active[k][0] / r for k, r in zip(keys, rates))
        t_ev = heap[0][0] if heap else np.inf
        t_next = min(t_tr, t_ev)
        if not np.isfinite(t_next):   # pragma: no cover - deadlock guard
            break
        if active:
            dt = t_next - t
            for k, r in zip(keys, rates):
                active[k][0] -= r * dt
        t = t_next
        for k in [k for k in list(active) if active[k][0] <= 1e-9 * bw]:
            complete_key(k, t)
        while heap and heap[0][0] <= t + 1e-15:
            _, _, kind, j = heapq.heappop(heap)
            if kind == 0:
                resolve(j, max(t, float(release[j])))
            else:
                on_finish(j, t)
    if started != n:
        raise RuntimeError("contended plan replay deadlocked "
                           "(bad plan sequences?)")
    return start, finish


def _commit_decision(g: TaskGraph, scheduler: Scheduler, state: MachineState,
                     j: int, ready: np.ndarray, decision,
                     times_matrix: np.ndarray, num_types: int):
    """Normalize one arrival decision (bare int or ``Decision``) and commit
    it: width-w commits claim w units atomically, the realized time shrinks
    by the task's curve."""
    d = as_decision(decision)
    if not 0 <= d.rtype < num_types:
        raise ValueError(f"scheduler {scheduler.name} returned bad type "
                         f"{d.rtype}")
    t = float(times_matrix[j, d.rtype])
    if d.width > 1:
        if g.speedup is None or d.width > g.max_width:
            raise ValueError(f"scheduler {scheduler.name} returned width "
                             f"{d.width} on a graph of max width {g.max_width}")
        t /= float(g.speedup[j, d.width - 1])
    pids, s, f = state.commit_wide(d.rtype, float(ready[d.rtype]), t, d.width)
    return d, pids, s, f


class _ArrivalLog:
    """Accumulates arrival-loop commitments into Schedule arrays (the
    width/procs fields stay ``None`` for all-rigid runs — byte parity)."""

    def __init__(self, n: int):
        self.alloc = np.zeros(n, dtype=np.int32)
        self.width = np.ones(n, dtype=np.int32)
        self.proc = np.zeros(n, dtype=np.int32)
        self.start = np.zeros(n)
        self.finish = np.zeros(n)
        self.units: list[tuple[int, ...]] = [()] * n
        self.wide = False

    def record(self, j: int, d, pids, s: float, f: float) -> None:
        self.alloc[j], self.width[j] = d.rtype, d.width
        self.proc[j], self.start[j], self.finish[j] = pids[0], s, f
        self.units[j] = pids
        self.wide = self.wide or d.width > 1

    def arrays(self):
        if not self.wide:
            return self.alloc, self.proc, self.start, self.finish, None, None
        return (self.alloc, self.proc, self.start, self.finish, self.width,
                tuple(self.units))


def _run_arrivals(g: TaskGraph, machine: Machine, scheduler: Scheduler,
                  times_matrix: np.ndarray, release: np.ndarray,
                  order: np.ndarray):
    """Arrival-driven loop: irrevocable (type, width, procs, start) per
    arrival."""
    from repro_torch.core.online import ready_per_type

    state = MachineState(machine.counts)
    log = _ArrivalLog(g.n)
    for j in order:
        j = int(j)
        ready = ready_per_type(g, j, log.finish, log.alloc, machine.num_types,
                               floor=float(release[j]))
        d, pids, s, f = _commit_decision(
            g, scheduler, state, j, ready,
            scheduler.on_task_arrival(j, ready, state), times_matrix,
            machine.num_types)
        log.record(j, d, pids, s, f)
    return log.arrays()


def run_arrivals_ready(g: TaskGraph, machine: Machine, scheduler: Scheduler,
                       times_matrix: np.ndarray, release: np.ndarray,
                       state: MachineState | None = None):
    """Event-driven arrival loop: tasks arrive when they become *ready* —
    every predecessor committed-and-finished and the release time passed —
    and are committed in ready-time order (ties broken by task id).

    This is the open-system semantics of ``repro_torch.streams``: with a single
    job released at 0 it visits tasks in a valid topological order, so it
    coincides with the paper's model up to the arrival permutation.

    ``state`` optionally seeds the machine with existing commitments — how
    the simulation-in-the-loop policy rolls a candidate out against the
    backlog it would actually face (the caller owns the state and should
    pass a clone when the run must not mutate it).
    """
    from repro_torch.core.online import ready_per_type

    n = g.n
    state = MachineState(machine.counts) if state is None else state
    log = _ArrivalLog(n)
    remaining = np.diff(g.pred_ptr).astype(np.int64)
    heap: list[tuple[float, int]] = [
        (float(release[j]), int(j)) for j in np.flatnonzero(remaining == 0)]
    heapq.heapify(heap)
    done = 0
    while heap:
        t, j = heapq.heappop(heap)
        ready = ready_per_type(g, j, log.finish, log.alloc, machine.num_types,
                               floor=max(float(release[j]), t))
        d, pids, s, f = _commit_decision(
            g, scheduler, state, j, ready,
            scheduler.on_task_arrival(j, ready, state), times_matrix,
            machine.num_types)
        log.record(j, d, pids, s, f)
        done += 1
        for v in map(int, g.succs(j)):
            remaining[v] -= 1
            if remaining[v] == 0:
                p0, p1 = g.pred_ptr[v], g.pred_ptr[v + 1]
                arr = max(float(release[v]),
                          float(log.finish[g.pred_idx[p0:p1]].max()))
                heapq.heappush(heap, (arr, v))
    if done != n:
        raise RuntimeError("ready-driven arrival loop stalled (cyclic graph?)")
    return log.arrays()


def simulate(g: TaskGraph, machine: Machine, scheduler: Scheduler, *,
             noise: NoiseModel | None = None, seed: int = 0,
             release: np.ndarray | None = None,
             order: np.ndarray | None = None,
             arrival: str = "order",
             job_of: np.ndarray | None = None,
             network=None,
             validate: bool = True, trace: bool = False) -> SimResult:
    """Run one scheduler over one instance under seeded stochastic runtimes.

    Args:
      g:        task graph whose ``proc`` holds runtime *estimates*.
      machine:  typed processor pools.
      scheduler: any object satisfying the ``Scheduler`` protocol.
      noise:    multiplicative runtime perturbation (default: none).
      seed:     RNG seed — same seed, same result, bit-for-bit.
      release:  optional (n,) release/arrival times (tasks cannot start
                earlier); turns the instance into an online one.
      order:    optional precedence-respecting arrival order for
                arrival-driven schedulers (default: ``g.topo``).
      arrival:  ``"order"`` — arrival-driven schedulers see tasks in the
                fixed ``order`` (the paper's §4.2 one-at-a-time model);
                ``"ready"`` — event-driven: tasks arrive when all their
                predecessors have finished and the release time has passed
                (the open-system model of ``repro_torch.streams``; ``order`` is
                then ignored).
      job_of:   optional (n,) job label per task for multi-job instances
                (a disjoint union of whole-DAG jobs released over time):
                the result then carries per-job completion spans and, with
                ``trace=True``, job_release/job_finish events.
      network:  optional ``repro_torch.sim.network.NetworkModel`` governing how
                cross-type transfers cost time.  ``None`` (the default) and
                ``FixedLatencyNetwork`` are the historical fixed per-edge
                delays, byte-identical; ``InstantNetwork`` executes
                transfers for free (the paper's ccr=0 model at execution
                time); contended models (``maxmin_fair``) replay static
                plans through the fluid event loop where concurrent
                transfers share link bandwidth.  Contended models need a
                static plan — arrival-driven schedulers under contention
                live in ``repro_torch.streams`` (causal tracker semantics).
      validate: check the two feasibility invariants on the result.
      trace:    record start/finish ``TraceEvent``s (off by default: cheap
                campaigns don't pay for them).
    """
    rng = np.random.default_rng(seed)
    actual = (noise or NoiseModel()).sample(g.proc, rng)
    release = np.zeros(g.n) if release is None else np.asarray(release, float)
    if release.shape != (g.n,):
        raise ValueError(f"release must be (n,), got {release.shape}")
    if arrival not in ("order", "ready"):
        raise ValueError(f"arrival must be 'order' or 'ready', got {arrival!r}")
    if job_of is not None:
        job_of = np.asarray(job_of, dtype=np.int64)
        if job_of.shape != (g.n,):
            raise ValueError(f"job_of must be (n,), got {job_of.shape}")

    sched_name = getattr(scheduler, "name", type(scheduler).__name__)
    with _obs.span("sim.allocate", scheduler=sched_name, n=g.n):
        plan = scheduler.allocate(g, machine)
    if plan is not None:
        with _obs.span("sim.execute", scheduler=sched_name, n=g.n):
            times = plan_times(g, plan, actual)
            if network is None:
                start, finish = _execute_plan(g, plan, times, release)
            elif network.contended:
                start, finish = _execute_plan_network(g, plan, times, release,
                                                      network)
            else:
                start, finish = _execute_plan(
                    g, plan, times, release,
                    delay=network.plan_delays(g, plan.alloc))
        sched = Schedule(alloc=np.asarray(plan.alloc, dtype=np.int32),
                         proc=np.asarray(plan.proc, dtype=np.int32),
                         start=start, finish=finish,
                         width=plan.width, procs=plan.procs)
    else:
        if network is not None and network.contended:
            raise ValueError(
                f"contended network model {network.name!r} needs a static "
                "plan in simulate(); arrival-driven contention runs through "
                "the streams engine (repro.streams.run_stream, not yet ported)")
        g_run = g
        if network is not None:
            # execution-accurate readiness: the arrival loops charge the
            # model's per-edge costs instead of the graph's fixed ones
            g_run = dataclasses.replace(g, comm=network.effective_comm(g))
        with _obs.span("sim.arrivals", scheduler=sched_name, n=g.n,
                       arrival=arrival):
            if arrival == "ready":
                alloc, proc, start, finish, width, procs = run_arrivals_ready(
                    g_run, machine, scheduler, actual, release)
            else:
                alloc, proc, start, finish, width, procs = _run_arrivals(
                    g_run, machine, scheduler, actual, release,
                    g.topo if order is None else order)
        sched = Schedule(alloc=alloc, proc=proc, start=start, finish=finish,
                         width=width, procs=procs)

    if validate:
        g_actual = dataclasses.replace(g, proc=actual)
        edge_delay = None if network is None \
            else network.validation_delays(g, sched.alloc)
        sched.validate(g_actual, machine, edge_delay=edge_delay)
        if (sched.start < release - 1e-9).any():
            raise AssertionError("task starts before its release time")

    events: tuple[TraceEvent, ...] = ()
    if trace:
        jl = (lambda j: int(job_of[j])) if job_of is not None else (lambda j: -1)
        ev = [TraceEvent(float(sched.start[j]), "start", j,
                         int(sched.alloc[j]), int(sched.proc[j]), jl(j),
                         sched.width_of(j))
              for j in range(g.n)]
        ev += [TraceEvent(float(sched.finish[j]), "finish", j,
                          int(sched.alloc[j]), int(sched.proc[j]), jl(j),
                          sched.width_of(j))
               for j in range(g.n)]
        if job_of is not None:
            for jid in map(int, np.unique(job_of)):
                sel = job_of == jid
                ev.append(TraceEvent(float(release[sel].min()), "job_release",
                                     jid, -1, -1, jid))
                ev.append(TraceEvent(float(sched.finish[sel].max()),
                                     "job_finish", jid, -1, -1, jid))
        # rank ties: a job's release precedes its tasks' starts, and its
        # finish follows the coincident last task finish
        rank = {"job_release": 0, "start": 1, "finish": 2, "job_finish": 3}
        events = tuple(sorted(ev, key=lambda e: (e.time, rank[e.event],
                                                 e.task)))
    return SimResult(schedule=sched, actual=actual, trace=events,
                     scheduler=sched_name, job_of=job_of)
