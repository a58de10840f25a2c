"""The open-system event loop: multi-tenant DAG jobs over one shared machine.

The port's copy of the JAX package's ``repro.streams.engine``, host code
(numpy, no torch), bit for bit.  It extends ``repro_torch.sim.engine``'s
single-instance semantics to a *stream*:
jobs (whole DAGs) are released over time by a source — an open-loop timed
list or a closed-loop think-time source — and every task is committed
irrevocably when it becomes *ready* (job released, all predecessors
finished), in ready-time order across all in-flight jobs.  The machine is
the same typed-pool ``MachineState`` the single-instance engine uses; the
policy sees it plus the per-type data-ready vector, exactly the §4.2
interface, so any ``repro_torch.sim`` adapter drops in unchanged
(``repro_torch.streams.policy.AdapterPolicy``).

Job completion events feed back into the source (closed-loop tenants
submit their next job one think time after the previous completes) and into
the ``TenantLedger`` that the open-system metrics aggregate.

Determinism: one run is a pure function of (source, policy, noise, seed).
Job j's realized runtimes come from ``default_rng([seed, jid])`` — the
noise stream of a job does not depend on what else is in flight.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np

from repro_torch.core.listsched import Schedule
from repro_torch.core.online import ready_per_type
from repro_torch.core.theory import makespan_lower_bound
from repro_torch.obs import registry as _obs
from repro_torch.platform import as_decision
from repro_torch.sim.engine import Machine, MachineState, NoiseModel

from .arrivals import Job
from .metrics import (BSLD_TAU, job_slowdowns, mean_queue_length,
                      tenant_summary, utilization)
from .tenants import JobRecord, TaskRecord, TenantLedger


class _JobState:
    """Mutable per-job bookkeeping while the job is in flight."""

    __slots__ = ("job", "g", "actual", "alloc", "width", "units", "proc",
                 "start", "finish", "remaining", "committed", "wide")

    def __init__(self, job: Job, actual: np.ndarray, graph=None):
        n = job.graph.n
        self.job = job
        self.g = job.graph if graph is None else graph  # readiness view
        self.actual = actual                      # (n, Q) realized times
        self.alloc = np.zeros(n, dtype=np.int32)
        self.width = np.ones(n, dtype=np.int32)
        self.units: list[tuple[int, ...]] = [()] * n
        self.proc = np.zeros(n, dtype=np.int32)
        self.start = np.zeros(n)
        self.finish = np.zeros(n)
        self.remaining = np.diff(job.graph.pred_ptr).astype(np.int64)
        self.committed = 0
        self.wide = False

    def schedule(self) -> Schedule:
        return Schedule(alloc=self.alloc, proc=self.proc, start=self.start,
                        finish=self.finish,
                        width=self.width if self.wide else None,
                        procs=tuple(self.units) if self.wide else None)


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Everything one open-system run produced."""

    policy: str
    machine: Machine
    jobs: list[JobRecord]
    tasks: list[TaskRecord]
    horizon: float
    #: ``TransferTracker`` log — (start, finish, links, size) per registered
    #: network transfer; populated only when a contended network ran with
    #: the obs registry enabled (the Perfetto link-lane source).
    transfers: tuple = ()

    def tenant_table(self, tau: float = BSLD_TAU) -> dict[int, dict[str, float]]:
        return tenant_summary(self.jobs, tau)

    def slowdowns(self, tau: float = BSLD_TAU) -> np.ndarray:
        return job_slowdowns(self.jobs, tau)

    def mean_slowdown(self, tau: float = BSLD_TAU) -> float:
        sd = self.slowdowns(tau)
        return float(sd.mean()) if sd.size else 1.0

    def utilization(self) -> np.ndarray:
        # active-span default (see ``metrics.utilization``): a late-starting
        # timed replay reports the same busy fractions as its t=0 shift
        return utilization(self.tasks, self.machine)

    def mean_queue_length(self) -> float:
        return mean_queue_length(self.tasks)


def _validate_stream(states: dict[int, _JobState], tasks: list[TaskRecord],
                     counts: list[int], network=None) -> None:
    """Feasibility across the whole stream: per-job precedence + release via
    ``Schedule.validate``, plus no overlap on any shared processor."""
    for js in states.values():
        g = dataclasses.replace(js.job.graph, proc=js.actual)
        edge_delay = (None if network is None
                      else network.validation_delays(g, js.alloc))
        js.schedule().validate(g, counts, edge_delay=edge_delay)
        if (js.start < js.job.arrival - 1e-9).any():
            raise AssertionError(
                f"job {js.job.jid}: task starts before the job's release")
    # expand width-w tasks to every unit they occupy, then check per unit
    by_proc: dict[tuple[int, int], list[TaskRecord]] = {}
    for t in tasks:
        units = states[t.jid].units[t.task] or (t.proc,)
        for u in units:
            by_proc.setdefault((t.rtype, u), []).append(t)
    for plist in by_proc.values():
        plist = sorted(plist, key=lambda t: t.start)
        for a, b in zip(plist[:-1], plist[1:]):
            if b.start < a.finish - 1e-9:
                raise AssertionError(
                    f"overlap on type {a.rtype} proc {a.proc}: "
                    f"jobs {a.jid}/{b.jid}")


def _contended_ready(js: _JobState, i: int, t: float, num_types: int,
                     tracker, cache: dict, network) -> np.ndarray:
    """(Q,) per-type data-ready times under a contended network.

    Candidate type q's readiness is the max over predecessor edges of:
    the pred's finish (same type, or the edge's object already cached at
    q), else the *estimated* finish of shipping the object — priced on a
    clone of the causal tracker, so multi-input candidates see their own
    transfers contend with each other and with everything in flight.
    """
    g = js.g
    sizes = g.data_sizes(network.bandwidth)
    oids = g.edge_out_ids()
    p0, p1 = g.pred_ptr[i], g.pred_ptr[i + 1]
    ready = np.full(num_types, float(t))
    for q in range(num_types):
        trk = tracker.clone()
        arr = float(t)
        for p, eid in zip(g.pred_idx[p0:p1], g.pred_eid[p0:p1]):
            p = int(p)
            if int(js.alloc[p]) == q:
                a = float(js.finish[p])
            else:
                key = (js.job.jid, p, int(oids[eid]), q)
                a = cache.get(key)
                if a is None:
                    a = trk.register(float(js.finish[p]), float(sizes[eid]),
                                     network.links_of(int(js.alloc[p]), q))
            arr = max(arr, a)
        ready[q] = arr
    return ready


def run_stream(source, machine: Machine, policy, *,
               noise: NoiseModel | None = None, seed: int = 0,
               validate: bool = True, network=None) -> StreamResult:
    """Run one policy over one job stream to completion.

    Args:
      source:  job source — ``initial_jobs() -> list[Job]`` plus
               ``on_job_complete(job, finish) -> Job | None`` (open-loop
               sources return None; closed-loop sources submit the tenant's
               next job).
      machine: shared typed processor pools.
      policy:  a stream policy — ``on_job_arrival(job, t, state, machine)``,
               ``assign(job, i, ready, state) -> type`` and optionally
               ``on_job_complete(job)`` (see ``repro_torch.streams.policy``).
      noise:   multiplicative runtime misprediction, seeded per job.
      seed:    stream-level seed; job jid draws ``default_rng([seed, jid])``.
      validate: check per-job precedence/release and cross-job non-overlap.
      network: optional ``repro_torch.sim.network.NetworkModel``.  Non-contended
               models substitute their effective per-edge costs into each
               job's readiness view (``None`` keeps today's fixed-latency
               charging bit-for-bit).  Contended models route every
               cross-type object through one shared causal
               ``TransferTracker`` — concurrent jobs' transfers share link
               bandwidth, and a reused output crossing the same boundary
               is shipped once (output caching).
    """
    noise = noise or NoiseModel()
    tracker = None
    xfer_cache: dict = {}
    if network is not None and network.contended:
        from repro_torch.sim.network import TransferTracker
        tracker = TransferTracker(network)
    ledger = TenantLedger()
    state = MachineState(machine.counts)
    counts = list(machine.counts)
    states: dict[int, _JobState] = {}
    # (time, kind, seq, payload): job releases sort before task arrivals at
    # equal times (kind 0 < 1); seq makes the order total and deterministic.
    seq = itertools.count()
    heap: list[tuple[float, int, int, object]] = []
    for job in source.initial_jobs():
        heapq.heappush(heap, (float(job.arrival), 0, next(seq), job))

    while heap:
        t, kind, _, payload = heapq.heappop(heap)
        if kind == 0:                                   # job release
            job: Job = payload                          # type: ignore[assignment]
            if job.jid in states:
                raise ValueError(f"duplicate job id {job.jid}")
            actual = noise.sample(job.graph.proc,
                                  np.random.default_rng([seed, job.jid]))
            g_eff = None
            if network is not None and not network.contended:
                g_eff = dataclasses.replace(
                    job.graph, comm=network.effective_comm(job.graph))
            js = states[job.jid] = _JobState(job, actual, graph=g_eff)
            policy.on_job_arrival(job, t, state, machine)
            for i in np.flatnonzero(js.remaining == 0):
                heapq.heappush(heap, (t, 1, next(seq), (js, int(i))))
            continue

        js, i = payload                                 # type: ignore[misc]
        g = js.g
        if tracker is not None:
            ready = _contended_ready(js, i, t, machine.num_types,
                                     tracker, xfer_cache, network)
        else:
            ready = ready_per_type(g, i, js.finish, js.alloc,
                                   machine.num_types, floor=t)
        d = as_decision(policy.assign(js.job, i, ready, state))
        q, w = d.rtype, d.width
        if not 0 <= q < machine.num_types:
            raise ValueError(f"policy {policy.name} returned bad type {q}")
        actual_t = float(js.actual[i, q])
        if w > 1:
            if g.speedup is None or w > g.max_width:
                raise ValueError(f"policy {policy.name} returned width {w} "
                                 f"on a graph of max width {g.max_width}")
            actual_t /= float(g.speedup[i, w - 1])
        if tracker is not None:
            # commit the chosen type's transfers for real: register each
            # uncached crossing object on the shared tracker (freezing its
            # finish) and cache it so later consumers reuse the one send
            p0, p1 = g.pred_ptr[i], g.pred_ptr[i + 1]
            sizes = g.data_sizes(network.bandwidth)
            oids = g.edge_out_ids()
            for p, eid in zip(g.pred_idx[p0:p1], g.pred_eid[p0:p1]):
                p = int(p)
                if int(js.alloc[p]) != q:
                    key = (js.job.jid, p, int(oids[eid]), q)
                    if key not in xfer_cache:
                        xfer_cache[key] = tracker.register(
                            float(js.finish[p]), float(sizes[eid]),
                            network.links_of(int(js.alloc[p]), q))
        js.alloc[i], js.width[i] = q, w
        js.wide = js.wide or w > 1
        pids, s, f = state.commit_wide(q, float(ready[q]), actual_t, w)
        js.units[i] = pids
        js.proc[i], js.start[i], js.finish[i] = pids[0], s, f
        js.committed += 1
        if _obs.enabled():
            _obs.bump("stream.tasks_committed")
        ledger.add_task(TaskRecord(jid=js.job.jid, task=i,
                                   tenant=js.job.tenant, rtype=q,
                                   proc=pids[0], arrival=t, start=s,
                                   finish=f, width=w,
                                   units=tuple(int(p) for p in pids)))
        for v in map(int, g.succs(i)):
            js.remaining[v] -= 1
            if js.remaining[v] == 0:
                p0, p1 = g.pred_ptr[v], g.pred_ptr[v + 1]
                arr = float(js.finish[g.pred_idx[p0:p1]].max())
                heapq.heappush(heap, (max(arr, float(js.job.arrival)), 1,
                                      next(seq), (js, v)))
        if js.committed == g.n:                          # job complete
            jfin = float(js.finish.max())
            # realized per-type busy *area*: width-w tasks occupy w units
            span = (js.finish - js.start) * js.width
            busy = tuple(float(span[js.alloc == qq].sum())
                         for qq in range(machine.num_types))
            ledger.add_job(JobRecord(
                jid=js.job.jid, tenant=js.job.tenant, name=js.job.name,
                arrival=float(js.job.arrival), start=float(js.start.min()),
                finish=jfin, ref=makespan_lower_bound(g, counts),
                n_tasks=g.n, busy=busy))
            hook = getattr(policy, "on_job_complete", None)
            if hook is not None:
                hook(js.job)
            nxt = source.on_job_complete(js.job, jfin)
            if nxt is not None:
                heapq.heappush(heap, (float(nxt.arrival), 0, next(seq), nxt))

    if validate:
        _validate_stream(states, ledger.tasks, counts, network=network)
    return StreamResult(policy=getattr(policy, "name", type(policy).__name__),
                        machine=machine, jobs=ledger.jobs,
                        tasks=ledger.tasks, horizon=ledger.horizon,
                        transfers=(tuple(tracker.log)
                                   if tracker is not None else ()))
