"""Open-system metrics: response time and bounded slowdown.

  * **response time** — job finish − job arrival;
  * **bounded slowdown** — ``max(response / max(ref, tau), 1)`` with the
    job's isolation lower bound as ``ref`` (Feitelson's bounded-slowdown
    metric; the ``tau`` floor keeps tiny jobs from dominating the tail).

Per-type utilization and queue-length series port with the simulation
slice, which provides the ``Machine`` they are measured against.
"""
from __future__ import annotations

import numpy as np

from .tenants import JobRecord

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
