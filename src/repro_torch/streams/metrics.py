"""Open-system metrics: response time, bounded slowdown, utilization, queues.

The port's copy of the JAX package's ``repro.streams.metrics`` (host code,
no torch).

Closed-campaign studies compare *makespans*; an open system is judged by
what each tenant experiences:

  * **response time** — job finish − job arrival;
  * **bounded slowdown** — ``max(response / max(ref, tau), 1)`` with the
    job's isolation lower bound as ``ref`` (Feitelson's bounded-slowdown
    metric; the ``tau`` floor keeps tiny jobs from dominating the tail);
  * **per-type utilization** — realized busy time per pool over the run
    horizon (is the expensive pool actually earning its keep?);
  * **queue lengths over time** — dispatchable-but-not-started task counts,
    the backlog signal bursty arrivals create.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sim.engine import Machine

from .tenants import JobRecord, TaskRecord

#: Default bounded-slowdown floor, in simulated time units.
BSLD_TAU = 1.0


def bounded_slowdown(response: float, ref: float, tau: float = BSLD_TAU) -> float:
    """Feitelson's bounded slowdown of one job; always >= 1."""
    return max(response / max(ref, tau), 1.0)


def job_slowdowns(jobs: list[JobRecord], tau: float = BSLD_TAU) -> np.ndarray:
    return np.asarray([bounded_slowdown(j.response, j.ref, tau) for j in jobs])


def tenant_summary(jobs: list[JobRecord], tau: float = BSLD_TAU
                   ) -> dict[int, dict[str, float]]:
    """Per-tenant open-system table: job count, mean response, mean/p50/p95
    bounded slowdown."""
    out: dict[int, dict[str, float]] = {}
    tenants = sorted({j.tenant for j in jobs})
    for t in tenants:
        sel = [j for j in jobs if j.tenant == t]
        sd = job_slowdowns(sel, tau)
        resp = np.asarray([j.response for j in sel])
        out[t] = {
            "jobs": float(len(sel)),
            "mean_response": float(resp.mean()),
            "mean_slowdown": float(sd.mean()),
            "p50_slowdown": float(np.percentile(sd, 50)),
            "p95_slowdown": float(np.percentile(sd, 95)),
        }
    return out


def utilization(tasks: list[TaskRecord], machine: Machine,
                horizon: float | None = None) -> np.ndarray:
    """(Q,) realized busy fraction per resource type over the *active span*.

    The default denominator is ``max(finish) - min(arrival)`` — the window
    the stream was actually live — not ``max(finish)`` from t=0: a timed
    replay whose first job arrives at t=1000 is just as busy as the same
    replay shifted to t=0, and used to report a near-zero fraction.  Pass
    ``horizon`` to override the span with an explicit *duration* (e.g. a
    fixed observation window).
    """
    if horizon is None:
        finish = max((t.finish for t in tasks), default=0.0)
        start = min((t.arrival for t in tasks), default=0.0)
        horizon = finish - start
    busy = np.zeros(machine.num_types)
    for t in tasks:
        busy[t.rtype] += (t.finish - t.start) * t.width  # w units occupied
    denom = np.asarray(machine.counts, dtype=float) * max(horizon, 1e-12)
    return np.divide(busy, denom, out=np.zeros_like(busy), where=denom > 0)


def queue_length_series(tasks: list[TaskRecord]
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Step series (times, depth): dispatchable-but-not-started task count.

    A task enters the queue at its ready/arrival event and leaves when it
    starts; ``depth[i]`` is the queue length just after ``times[i]``.
    """
    if not tasks:
        return np.zeros(0), np.zeros(0, dtype=np.int64)
    # at equal times the arrival counts before the start, so a zero-wait
    # task contributes [+1, -1] and the depth never dips negative
    events = sorted([(t.arrival, 1) for t in tasks]
                    + [(t.start, -1) for t in tasks],
                    key=lambda e: (e[0], -e[1]))
    times = np.asarray([e[0] for e in events])
    depth = np.cumsum([e[1] for e in events])
    return times, depth


def mean_queue_length(tasks: list[TaskRecord]) -> float:
    """Time-averaged queue length over the run (0 for an empty run)."""
    times, depth = queue_length_series(tasks)
    if times.size < 2:
        return 0.0
    dt = np.diff(times)
    span = times[-1] - times[0]
    if span <= 0:
        return 0.0
    return float((depth[:-1] * dt).sum() / span)
