"""Stream allocation policies — including simulation-in-the-loop.

The port's copy of the JAX package's ``repro.streams.policy``.  Its
rollouts replay on the card: ``SimInTheLoop`` scores each job's candidate
plans through ``repro_torch.sim.batch.sweep_suite_makespans``, one launch of
the replay kernel (``kernels/csrc/replay_sm90.cu``) per shape bucket, on
the ``device`` it is given (the card unless the caller passes ``"cpu"``,
which takes the kernel's plain version).  The makespans are the
reference's float32 ones, so the argmin picks the same candidate.

A stream policy takes the open system's irrevocable per-task allocation
decision:

  * ``on_job_arrival(job, t, state, machine)`` — the whole DAG is revealed;
  * ``assign(job, i, ready, state) -> Decision | type`` — task ``i`` of
    ``job`` is ready; ``ready`` is the (Q,) per-type data-ready vector and
    ``state`` the shared committed-machine view.  The return value is a
    ``repro_torch.platform.Decision`` (type + moldable width) — a bare type int,
    the deprecated pre-v2 protocol, is read as width 1;
  * ``on_job_complete(job)`` — bookkeeping hook.

``AdapterPolicy`` lifts any ``repro_torch.sim`` adapter into this interface:
arrival-driven adapters (er_ls, eft, greedy_*, random) decide per task
against the *shared* machine state; static planners (heft, hlp_*) plan each
job at its arrival and contribute their allocation (the machine itself is
list-scheduled greedily across jobs — the paper's two-phase split, applied
per job).

``SimInTheLoop`` is the ROADMAP's simulation-in-the-loop allocator: at each
job arrival it materializes candidate plans (ER-LS rollout, HEFT-comm,
greedy variants), conditions them on the *current* machine state via
per-task start floors (``rollout_floors``), evaluates every
(candidate × rollout-seed) makespan through the padded/bucketed
evaluator (``sweep_suite_makespans(envelope=True)`` — one replay shape per
bucket across the whole stream, each bucket's plan axis split over the
campaign's cards exactly like the offline campaigns), and commits the job to the
argmin candidate's allocation.  When a latency budget is set and the observed
rollout cost exceeds it, the policy degrades to plain ER-LS — the paper's
online rule — so the allocator never stalls the dispatch path.
"""
from __future__ import annotations

import heapq
import time

import numpy as np

from repro_torch.core.listsched import Schedule
from repro_torch.obs import registry as _obs
from repro_torch.sim.adapters import FrozenPlanScheduler, make_scheduler
from repro_torch.sim.batch import rollout_floors, sweep_suite_makespans
from repro_torch.sim.pipeline import cached_allocate
from repro_torch.sim.engine import (Machine, MachineState, NoiseModel, Plan,
                                    run_arrivals_ready)

from .arrivals import Job


def _clone_state(busy: list[np.ndarray], now: float,
                 counts: tuple[int, ...]) -> MachineState:
    """A fresh ``MachineState`` whose processors only free up at the given
    horizons (relative to ``now``) — the backlog a rollout conditions on."""
    st = MachineState(counts)
    st.free = [[(max(float(b) - now, 0.0), p) for p, b in enumerate(bq)]
               for bq in busy]
    for h in st.free:
        heapq.heapify(h)
    return st


def conditioned_plan(adapter: str, g, machine: Machine,
                     busy: list[np.ndarray], now: float, **kw) -> Plan:
    """Materialize a candidate as the schedule it would actually produce
    against the current backlog: run the ready-order arrival loop from a
    cloned busy ``MachineState`` on the runtime estimates.  Static adapters
    contribute their *allocation* (what the open system keeps of a static
    plan); arrival-driven ones take their per-task decisions against the
    busy state — so every candidate's plan has realistic sequences, and its
    floored replay through the bucketed evaluator predicts its response.
    """
    sched = make_scheduler(adapter, **kw)
    plan0 = cached_allocate(sched, g, machine)
    if plan0 is not None:
        sched = FrozenPlanScheduler(plan0, name=adapter)
    alloc, proc, start, finish, width, procs = run_arrivals_ready(
        g, machine, sched, g.proc, np.zeros(g.n),
        state=_clone_state(busy, now, machine.counts))
    return Plan.from_schedule(
        Schedule(alloc=alloc, proc=proc, start=start, finish=finish,
                 width=width, procs=procs), machine)


class StreamPolicy:
    """Base: no-op job hooks; subclasses implement ``assign``."""

    name = "stream"

    def on_job_arrival(self, job: Job, t: float, state: MachineState,
                       machine: Machine) -> None:
        pass

    def on_job_complete(self, job: Job) -> None:
        pass

    def assign(self, job: Job, i: int, ready: np.ndarray,
               state: MachineState) -> int:
        raise NotImplementedError


class AdapterPolicy(StreamPolicy):
    """Any ``repro_torch.sim`` adapter as a per-job stream policy.

    A fresh adapter instance is built per job (so per-job state like the
    random adapter's RNG stays reproducible: its seed is derived from the
    job id), and static adapters re-plan on the job's own DAG at arrival.
    """

    def __init__(self, adapter: str, **kw):
        self.adapter = adapter
        self.name = adapter
        self._kw = kw
        self._by_job: dict[int, tuple] = {}

    def on_job_arrival(self, job, t, state, machine):
        kw = dict(self._kw)
        if self.adapter == "random":
            kw.setdefault("seed", job.jid)
        sched = make_scheduler(self.adapter, **kw)
        plan = sched.allocate(job.graph, machine)
        self._by_job[job.jid] = (sched, plan)

    def assign(self, job, i, ready, state):
        sched, plan = self._by_job[job.jid]
        if plan is not None:
            return plan.decision(i)
        return sched.on_task_arrival(i, ready, state)

    def on_job_complete(self, job):
        self._by_job.pop(job.jid, None)


#: Default rollout candidates; jobs whose DAGs carry edge transfer costs
#: additionally materialize the comm-aware allocation pipeline (its LP
#: prices the transfers the stream engine will actually charge).
DEFAULT_CANDIDATES = ("er_ls", "eft", "heft", "greedy_r2")
COMM_CANDIDATES = DEFAULT_CANDIDATES + ("cahlp_ols",)
#: Opt-in candidate set adding the population-based plan search
#: (``repro_torch.search`` via the ``evo`` adapter) to the rollout pool — the
#: search re-plans per arrival, so reserve it for latency budgets that can
#: afford a small evolve run: ``SimInTheLoop(candidates=SEARCH_CANDIDATES)``.
SEARCH_CANDIDATES = DEFAULT_CANDIDATES + ("evo",)
#: Adapters that take a ``device`` (the plan search scores on it, the
#: first-order LP solves on it).
_ON_DEVICE = ("evo", "evo_camhlp", "hlp_jax_ols")


class SimInTheLoop(StreamPolicy):
    """Pick each job's allocation by cheap vmapped rollouts at arrival.

    Args:
      candidates:    adapter names whose materialized plans compete; each is
                     conditioned on the current backlog via
                     ``conditioned_plan`` before evaluation.  ``None`` (the
                     default) selects per job: ``DEFAULT_CANDIDATES``, plus
                     the comm-aware ``cahlp_ols`` allocator
                     (``COMM_CANDIDATES``) when the job's DAG carries edge
                     transfer costs.  Pass ``SEARCH_CANDIDATES`` to let the
                     ``evo`` plan search compete per arrival.
      rollout_seeds: noise seeds per rollout; with ``rollout_noise=None``
                     a single estimate-replay rollout per candidate.
      rollout_noise: optional misprediction model applied inside rollouts.
      budget_s:      soft per-arrival latency budget.  The policy tracks an
                     EWMA of observed rollout wall-clock (the first rollout
                     is treated as warmup and not recorded — it pays the
                     one-time kernel build); while the EWMA exceeds the
                     budget, jobs fall back to ``fallback`` (plain ER-LS)
                     without rolling out, and the estimate decays on every
                     skipped arrival so the policy re-qualifies once the
                     spike has passed.  ``None`` = always roll out
                     (deterministic; what tests and campaigns use).
      fallback:      arrival-driven adapter used when over budget.
      device:        where the rollouts replay (and the candidates that
                     score or solve on a device, ``evo`` and
                     ``hlp_jax_ols``, run): ``"cuda"``, the replay kernel;
                     ``"cpu"``, its plain version.
    """

    def __init__(self, candidates=None, *,
                 rollout_seeds=(0,), rollout_noise: NoiseModel | None = None,
                 budget_s: float | None = None, fallback: str = "er_ls",
                 device="cuda"):
        from repro_torch.device import resolve_device
        self.device = resolve_device(device)
        self._auto_candidates = candidates is None
        self.candidates = (DEFAULT_CANDIDATES if candidates is None
                           else tuple(candidates))
        if not self.candidates:
            raise ValueError("need at least one candidate")
        self.rollout_seeds = list(rollout_seeds)
        self.rollout_noise = rollout_noise or NoiseModel()
        self.budget_s = budget_s
        self.fallback = AdapterPolicy(fallback)
        self.name = "sim_in_the_loop"
        self._chosen: dict[int, tuple] = {}
        self._cost_ema: float | None = None
        self._warm = False
        #: (jid, chosen candidate | fallback name) — introspection/tests.
        self.decisions: list[tuple[int, str]] = []

    def _kw(self, adapter: str) -> dict:
        """The device for the adapters that score or solve on one."""
        return ({"device": str(self.device)} if adapter in _ON_DEVICE
                else {})

    def _over_budget(self) -> bool:
        return (self.budget_s is not None and self._cost_ema is not None
                and self._cost_ema > self.budget_s)

    def on_job_arrival(self, job, t, state, machine):
        # the fallback tracks every job so it can serve assign() any time
        self.fallback.on_job_arrival(job, t, state, machine)
        if self._over_budget():
            self._cost_ema *= 0.9   # decay while skipping, so a transient
            # spike (GC pause, new bucket compile) doesn't latch the
            # fallback for the rest of the stream
            self.decisions.append((job.jid, f"fallback:{self.fallback.name}"))
            if _obs.enabled():
                _obs.bump("stream.rollout_fallbacks")
            return
        t0 = time.perf_counter()
        cands = (COMM_CANDIDATES
                 if self._auto_candidates and job.graph.has_comm
                 else self.candidates)
        with _obs.span("stream.rollout", jid=job.jid,
                       candidates=len(cands)):
            busy = [state.busy_until(q) for q in range(machine.num_types)]
            plans = [conditioned_plan(c, job.graph, machine, busy, t,
                                      **self._kw(c))
                     for c in cands]
            sweeps = sweep_suite_makespans(
                [(job.graph, machine, FrozenPlanScheduler(p, name=c))
                 for c, p in zip(cands, plans)],
                noise=self.rollout_noise, seeds=self.rollout_seeds,
                floor_fn=lambda g, p: rollout_floors(g, p, busy, now=t),
                envelope=True, device=self.device)
        best = cands[int(np.argmin([float(s.mean()) for s in sweeps]))]
        if _obs.enabled():
            _obs.bump("stream.rollouts")
        # The winner is installed as the job's *allocator*, not a frozen
        # allocation: arrival-driven winners keep deciding per task against
        # the machine state as it actually evolves (freezing the arrival-time
        # allocation measurably loses under bursty backlog — adaptation is
        # worth more than the rollout's foresight).
        sched = make_scheduler(best, **self._kw(best))
        self._chosen[job.jid] = (sched,
                                 cached_allocate(sched, job.graph, machine))
        self.decisions.append((job.jid, best))
        dt = time.perf_counter() - t0
        if self._warm:   # the first rollout pays the one-time kernel build;
            # recording it would latch the fallback permanently
            self._cost_ema = dt if self._cost_ema is None \
                else 0.5 * (self._cost_ema + dt)
        self._warm = True

    def assign(self, job, i, ready, state):
        chosen = self._chosen.get(job.jid)
        if chosen is None:
            return self.fallback.assign(job, i, ready, state)
        sched, plan = chosen
        if plan is not None:
            return plan.decision(i)
        return sched.on_task_arrival(i, ready, state)

    def on_job_complete(self, job):
        self._chosen.pop(job.jid, None)
        self.fallback.on_job_complete(job)


#: Stream-policy registry: every sim adapter, plus the rollout allocator.
def make_policy(name: str, *, device="cuda", **kw) -> StreamPolicy:
    """A stream policy by name; ``device`` is where a simulation-in-the-loop
    policy's rollouts replay (and where an adapter that takes a device
    runs)."""
    if name in ("sim_in_the_loop", "sitl"):
        return SimInTheLoop(device=device, **kw)
    if name in _ON_DEVICE:
        kw.setdefault("device", str(device))
    return AdapterPolicy(name, **kw)
