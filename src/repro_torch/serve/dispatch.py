"""On-line request dispatch over heterogeneous pools — the paper's ER-LS as
the serving scheduler, with a Step-1-based straggler backup rule.

A serving fleet has Q heterogeneous worker pools (e.g. prefill-optimized
pods vs decode-optimized pods vs CPU-host overflow; or new-gen vs old-gen
accelerators).  Each request is a 2-task chain  prefill ≺ decode-phase  with
per-pool processing-time estimates from a calibrated cost model — exactly the
paper's (CPU, GPU) | prec | C_max setting, arriving online.

This module is a thin serving veneer over the shared scheduling substrate:
the pool decision *is* ``repro_torch.core.online.erls_decide``, pool
occupancy *is* ``repro_torch.platform.PoolState`` (the committed-schedule
view every online policy sees), and per-tenant accounting flows through
``repro_torch.streams``' ``JobRecord``/metrics, so a dispatcher log
aggregates with the same bounded-slowdown tables as the open-system
campaigns.  A copy of the JAX package's ``repro.serve.dispatch``.

Straggler mitigation reuses Step 1 as a *backup* rule: when a running task
exceeds its estimate by ``straggler_factor``, a duplicate is enqueued iff the
other pool could finish it before the straggler's revised estimate — the
same comparison, applied at detection time.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.dag import GPU
from repro_torch.core.online import erls_decide
from repro_torch.platform import Decision, PoolState, as_decision
from repro_torch.streams.metrics import tenant_summary
from repro_torch.streams.tenants import JobRecord


@dataclasses.dataclass
class Pool:
    """A homogeneous group of workers (one resource type).

    Occupancy is delegated to a single-type ``PoolState`` — the same
    committed-schedule view the simulation engine's online policies
    condition on."""

    name: str
    workers: int
    speed: float = 1.0             # relative throughput multiplier

    def __post_init__(self):
        self._state = PoolState((self.workers,))

    def earliest_idle(self, width: int = 1) -> float:
        return self._state.earliest_idle(0, width)

    def commit(self, ready: float, work: float,
               width: int = 1) -> tuple[int, float, float]:
        pids, s, f = self._state.commit_wide(0, ready, work / self.speed,
                                             width)
        return pids[0], s, f


@dataclasses.dataclass
class Request:
    rid: int
    prompt_tokens: int
    decode_tokens: int
    arrival: float
    tenant: int = 0


@dataclasses.dataclass
class Placement:
    rid: int
    phase: str                 # prefill | decode
    pool: str
    worker: int
    start: float
    finish: float
    backup: bool = False
    width: int = 1             # workers occupied (the ``Decision`` width)


class ERLSDispatcher:
    """Irrevocable two-pool dispatch (paper §4.2) + straggler backups.

    The per-phase decision calls ``repro_torch.core.online.erls_decide``,
    with (slow, fast) mapped onto the paper's (CPU, GPU) convention.
    """

    def __init__(self, slow: Pool, fast: Pool, cost_model,
                 straggler_factor: float = 3.0):
        assert slow.workers >= fast.workers, "paper convention: m >= k"
        self.slow, self.fast = slow, fast
        self.cost = cost_model          # (request, phase, pool) -> seconds
        self.sf = straggler_factor
        self.log: list[Placement] = []
        #: (rid, phase, Decision) — the dispatcher's first-class decision log
        self.decisions: list[tuple[int, str, Decision]] = []
        self._reqs: dict[int, Request] = {}

    def _pool_of(self, d: Decision) -> Pool:
        return self.fast if d.rtype == GPU else self.slow

    def _decide(self, req: Request, phase: str, ready: float) -> Decision:
        """The per-phase allocation as a ``Decision`` record — the same
        (type, width) object every other decision surface consumes (serving
        requests are rigid, so the width is always 1 here)."""
        p_slow = self.cost(req, phase, self.slow)
        p_fast = self.cost(req, phase, self.fast)
        r_fast = max(self.fast.earliest_idle(), ready)
        return as_decision(erls_decide(p_slow, p_fast, self.slow.workers,
                                       self.fast.workers, r_fast))

    def submit(self, req: Request) -> list[Placement]:
        """Dispatch the prefill ≺ decode chain; returns the placements."""
        out = []
        ready = req.arrival
        self._reqs[req.rid] = req
        for phase in ("prefill", "decode"):
            d = self._decide(req, phase, ready)
            self.decisions.append((req.rid, phase, d))
            pool = self._pool_of(d)
            work = self.cost(req, phase, pool) * pool.speed
            wid, start, finish = pool.commit(ready, work, d.width)
            out.append(Placement(req.rid, phase, pool.name, wid, start,
                                 finish, width=d.width))
            ready = finish
        self.log.extend(out)
        return out

    def maybe_backup(self, pl: Placement, observed_elapsed: float,
                     req: Request) -> Placement | None:
        """Straggler rule: expected finish under the straggler estimate vs a
        fresh run on the other pool (paper Step 1 at detection time)."""
        expected = pl.finish - pl.start
        if observed_elapsed < self.sf * expected:
            return None
        other = self.fast if pl.pool == self.slow.name else self.slow
        p_other = self.cost(req, pl.phase, other)
        revised_finish = pl.start + self.sf * expected
        if revised_finish >= other.earliest_idle() + p_other:
            wid, start, finish = other.commit(pl.start + observed_elapsed,
                                              p_other * other.speed)
            bk = Placement(pl.rid, pl.phase, other.name, wid, start, finish,
                           backup=True)
            self.log.append(bk)
            return bk
        return None

    @property
    def makespan(self) -> float:
        return max((p.finish for p in self.log), default=0.0)

    # ----------------------------------------------------- tenant accounting
    def job_records(self):
        """Each dispatched request as a ``streams`` ``JobRecord``.

        The isolation reference is the request served back-to-back on its
        per-phase best pools — so the dispatcher's log aggregates with the
        same bounded-slowdown machinery as the open-system campaigns.
        A phase served by several copies (straggler backups) completes at
        the *earliest* copy's finish; every copy's runtime — duplicate work
        included — counts toward the busy totals."""
        by_phase: dict[tuple[int, str], list[Placement]] = {}
        for p in self.log:
            by_phase.setdefault((p.rid, p.phase), []).append(p)
        by_rid: dict[int, list[list[Placement]]] = {}
        for (rid, _), copies in by_phase.items():
            by_rid.setdefault(rid, []).append(copies)
        recs = []
        for rid, phases in sorted(by_rid.items()):
            req = self._reqs[rid]
            ref = sum(min(self.cost(req, ph, self.slow),
                          self.cost(req, ph, self.fast))
                      for ph in ("prefill", "decode"))
            all_pls = [p for copies in phases for p in copies]
            busy_fast = sum(p.finish - p.start for p in all_pls
                            if p.pool == self.fast.name)
            busy_slow = sum(p.finish - p.start for p in all_pls
                            if p.pool == self.slow.name)
            recs.append(JobRecord(
                jid=rid, tenant=req.tenant, name=f"req{rid}",
                arrival=req.arrival,
                start=min(p.start for p in all_pls),
                finish=max(min(p.finish for p in copies)
                           for copies in phases), ref=ref,
                n_tasks=len(all_pls), busy=(busy_slow, busy_fast)))
        return recs

    def tenant_table(self, tau: float = 1e-3):
        """Per-tenant mean/p50/p95 bounded slowdown of the dispatch log."""

        return tenant_summary(self.job_records(), tau)


def token_cost_model(prefill_flops_per_tok: float = 2e9,
                     decode_flops_per_tok: float = 2e9,
                     pool_flops: dict | None = None):
    """Analytic per-pool cost model (seconds) from token counts."""
    pool_flops = pool_flops or {}

    def cost(req: Request, phase: str, pool: Pool) -> float:
        rate = pool_flops.get(pool.name, 1e12) * pool.speed
        if phase == "prefill":
            return req.prompt_tokens * prefill_flops_per_tok / rate
        return req.decode_tokens * decode_flops_per_tok / rate

    return cost
