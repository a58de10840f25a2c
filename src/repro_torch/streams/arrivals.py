"""Seeded arrival processes emitting whole-DAG jobs into the open system.

The port's copy of the JAX package's ``repro.streams.arrivals``: host code
(numpy-seeded, no torch) that draws the same jobs and arrival times bit for
bit.

The paper's on-line setting (§4.2) reveals the tasks of *one* application
one at a time; the ROADMAP's north star is an open system: whole DAG jobs
from many tenants arriving over time and competing for the same typed
pools.  This module generates those job streams:

  * ``PoissonProcess``  — memoryless arrivals at a fixed rate, the M/G/…
                          baseline of every queueing study.
  * ``MMPPProcess``     — 2-state Markov-modulated Poisson process: the
                          stream alternates between a quiet and a burst
                          state with exponential dwell times, each with its
                          own rate.  Bursty traffic is where allocation
                          quality shows up in tail slowdown.
  * ``ClosedLoopSource``— per-tenant think time: each tenant keeps one job
                          in flight and submits the next one an exponential
                          think time after the previous completes (the
                          interactive closed-system model).

``JobFactory`` draws the job bodies — whole ``TaskGraph``s from the
``repro_torch.sim.scenarios`` families — from a seeded generator, so a
stream is a pure function of ``(process params, factory params, seed)``:
``open_stream(...)`` with the same arguments always yields byte-identical
jobs and arrival times (the determinism property tests rely on it).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dag import TaskGraph
from repro_torch.sim.scenarios import make_scenario


@dataclasses.dataclass(frozen=True)
class Job:
    """One unit of tenant work: a whole DAG released at ``arrival``."""

    jid: int
    tenant: int
    arrival: float
    graph: TaskGraph
    name: str = ""

    @property
    def n(self) -> int:
        return self.graph.n


# ----------------------------------------------------------------- factory
#: Per-family default sizes for stream jobs — small enough that a
#: simulation-in-the-loop rollout over a handful of candidates stays cheap,
#: large enough that allocation quality moves the response time.
DEFAULT_JOB_PARAMS: dict[str, dict] = {
    "chain": dict(n=12),
    "fork_join": dict(width=8, phases=2),
    "layered": dict(n=24, layers=4),
    "random": dict(n=16),
    "netbound": dict(width=6, depth=3),
    "cholesky": dict(nb_blocks=3),
    "lu": dict(nb_blocks=3),
    # the scenario machine is ignored by the stream (jobs contribute only
    # their graph), but the counts knob caps the curve widths drawn here
    "moldable_cholesky": dict(nb_blocks=3, counts=(8, 4)),
}


class JobFactory:
    """Seeded draw of whole-DAG jobs from the scenario families.

    Each ``make`` consumes from the caller's generator: the family is drawn
    uniformly, then a fresh graph seed — so the stream of job bodies is
    reproducible from the stream seed alone.
    """

    def __init__(self, families=("fork_join", "layered", "random"), *,
                 num_types: int = 2, ccr: float = 0.0,
                 params: dict[str, dict] | None = None):
        self.families = tuple(families)
        if not self.families:
            raise ValueError("need at least one scenario family")
        self.num_types = num_types
        self.ccr = ccr
        self.params = {**DEFAULT_JOB_PARAMS, **(params or {})}

    def make(self, jid: int, tenant: int, arrival: float,
             rng: np.random.Generator) -> Job:
        fam = self.families[int(rng.integers(len(self.families)))]
        gseed = int(rng.integers(2 ** 31 - 1))
        kw = dict(counts=(1, 1), num_types=self.num_types, ccr=self.ccr,
                  seed=gseed)
        kw.update(self.params.get(fam, {}))   # per-family knobs may override
        sc = make_scenario(fam, **kw)
        return Job(jid=jid, tenant=tenant, arrival=float(arrival),
                   graph=sc.graph, name=sc.name)


# --------------------------------------------------------- open-loop timing
class PoissonProcess:
    """Arrivals at ``rate`` jobs per unit of simulated time."""

    name = "poisson"

    def __init__(self, rate: float):
        if rate <= 0:
            raise ValueError("rate must be positive")
        self.rate = float(rate)

    def arrival_times(self, num_jobs: int, rng: np.random.Generator) -> np.ndarray:
        return np.cumsum(rng.exponential(1.0 / self.rate, size=num_jobs))


class MMPPProcess:
    """2-state Markov-modulated Poisson process (quiet ⇄ burst).

    ``rates[s]`` is the arrival rate in state s, ``dwell[s]`` the mean
    (exponential) time spent there before switching.  With
    ``rates = (0.05, 0.5)`` the burst state packs ~10× the traffic of the
    quiet state into short windows — the backlog those windows build is
    what separates allocation policies.
    """

    name = "mmpp"

    def __init__(self, rates: tuple[float, float] = (0.05, 0.5),
                 dwell: tuple[float, float] = (80.0, 20.0)):
        if min(rates) <= 0 or min(dwell) <= 0:
            raise ValueError("rates and dwell times must be positive")
        self.rates = (float(rates[0]), float(rates[1]))
        self.dwell = (float(dwell[0]), float(dwell[1]))

    def arrival_times(self, num_jobs: int, rng: np.random.Generator) -> np.ndarray:
        out: list[float] = []
        t, s = 0.0, 0
        switch = rng.exponential(self.dwell[0])
        while len(out) < num_jobs:
            gap = rng.exponential(1.0 / self.rates[s])
            if t + gap < switch:
                t += gap
                out.append(t)
            else:                      # dwell expired: move to the switch,
                t = switch             # flip state, re-draw (memorylessness
                s ^= 1                 # makes the discard exact)
                switch = t + rng.exponential(self.dwell[s])
        return np.asarray(out)


# ------------------------------------------------------------------ sources
class OpenLoopSource:
    """A fixed timed job list (Poisson / MMPP draw, or a replayed trace)."""

    def __init__(self, jobs: list[Job]):
        self.jobs = sorted(jobs, key=lambda j: (j.arrival, j.jid))

    def initial_jobs(self) -> list[Job]:
        return list(self.jobs)

    def on_job_complete(self, job: Job, finish: float) -> Job | None:
        return None


def open_stream(process, factory: JobFactory, *, num_jobs: int,
                num_tenants: int = 4, seed: int = 0) -> OpenLoopSource:
    """Materialize an open-loop stream: deterministic under ``seed``."""
    rng = np.random.default_rng([seed, 0x57A3])
    times = process.arrival_times(num_jobs, rng)
    jobs = [factory.make(i, int(rng.integers(num_tenants)), float(times[i]),
                         rng)
            for i in range(num_jobs)]
    return OpenLoopSource(jobs)


class ClosedLoopSource:
    """Interactive tenants: one job in flight each, exponential think time.

    The (j+1)-th job of a tenant arrives ``Exp(think)`` after its j-th job
    *completes* — so the arrival stream depends on scheduling quality, the
    defining feedback of a closed system.  Deterministic given the seed
    *and* the policy under test (completions feed the stream).
    """

    name = "closed_loop"

    def __init__(self, factory: JobFactory, *, num_tenants: int = 4,
                 think: float = 5.0, jobs_per_tenant: int = 4, seed: int = 0):
        self.factory = factory
        self.think = float(think)
        self.num_tenants = num_tenants
        self._rng = np.random.default_rng([seed, 0xC105])
        self._initial = [
            factory.make(t, t, float(self._rng.exponential(self.think)),
                         self._rng)
            for t in range(num_tenants)]
        self._remaining = {t: jobs_per_tenant - 1 for t in range(num_tenants)}
        self._next_jid = num_tenants

    def initial_jobs(self) -> list[Job]:
        return list(self._initial)

    def on_job_complete(self, job: Job, finish: float) -> Job | None:
        if self._remaining.get(job.tenant, 0) <= 0:
            return None
        self._remaining[job.tenant] -= 1
        jid = self._next_jid
        self._next_jid += 1
        arrival = finish + float(self._rng.exponential(self.think))
        return self.factory.make(jid, job.tenant, arrival, self._rng)
