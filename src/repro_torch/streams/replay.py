"""Trace replay: ESTEE workflow files and Chameleon workloads as job streams.

The port's copy of the JAX package's ``repro.streams.replay`` (host code,
no torch).

Two ingestion paths turn *recorded* workflows into timed open-system
streams:

  * ``replay_estee(paths, ...)`` — each ESTEE-format JSON file
    (``repro_torch.sim.scenarios.from_estee``) becomes one job; arrival times
    either come with the trace (``arrivals=[...]``, a timed replay) or are
    drawn from a seeded Poisson process (rate-controlled replay of the same
    workflow mix).
  * ``chameleon_stream(...)`` — the paper's §6.1 Chameleon applications
    (potrf/getrf/posv/…) replayed as a stream: each job is one tiled
    application instance with a seeded size draw, the dense-linear-algebra
    traffic a shared cluster actually serves.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.workloads import chameleon
from repro_torch.sim.scenarios import from_estee, with_ccr

from .arrivals import Job, OpenLoopSource


def replay_estee(paths, *, arrivals=None, rate: float = 0.1,
                 num_tenants: int | None = None, seed: int = 0,
                 num_types: int = 2, bandwidth: float = 1.0) -> OpenLoopSource:
    """Replay ESTEE workflow traces as a timed job stream.

    Args:
      paths:    one path per job, in submission order.
      arrivals: optional explicit arrival times (same length as ``paths``) —
                the timed-replay mode; default draws Poisson(``rate``)
                inter-arrivals from ``seed``.
      num_tenants: tenants assigned round-robin over jobs (default: one
                tenant per distinct trace file).
      seed, num_types, bandwidth: forwarded to ``from_estee`` so the
                duration→per-type synthesis is reproducible.
    """
    paths = list(paths)
    if not paths:
        raise ValueError("need at least one trace path")
    rng = np.random.default_rng([seed, 0x8E91])
    if arrivals is None:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=len(paths)))
    arrivals = np.asarray(arrivals, dtype=np.float64)
    if arrivals.shape != (len(paths),):
        raise ValueError(f"arrivals must match paths, got {arrivals.shape}")
    if num_tenants is None:
        uniq = {p: i for i, p in enumerate(dict.fromkeys(map(str, paths)))}
        tenant_of = [uniq[str(p)] for p in paths]
    else:
        tenant_of = [i % num_tenants for i in range(len(paths))]
    jobs = []
    for i, (p, arr) in enumerate(zip(paths, arrivals)):
        sc = from_estee(p, num_types=num_types, bandwidth=bandwidth,
                        seed=seed + i, counts=(1, 1))
        jobs.append(Job(jid=i, tenant=tenant_of[i], arrival=float(arr),
                        graph=sc.graph, name=sc.name))
    return OpenLoopSource(jobs)


def chameleon_stream(apps=("potrf", "getrf"), *, num_jobs: int = 12,
                     nb_blocks=(3, 4), block_size: int = 320,
                     num_tenants: int = 2, rate: float = 0.05,
                     ccr: float = 0.0, num_types: int = 2,
                     seed: int = 0) -> OpenLoopSource:
    """The existing Chameleon workloads as a timed multi-tenant job stream.

    Each job is one tiled application drawn uniformly from ``apps`` with a
    tile count drawn from ``nb_blocks`` — a seeded, deterministic stream of
    the §6.1 instances arriving Poisson(``rate``).
    """
    rng = np.random.default_rng([seed, 0xC4A3])
    times = np.cumsum(rng.exponential(1.0 / rate, size=num_jobs))
    nbs = tuple(np.atleast_1d(nb_blocks).astype(int))
    jobs = []
    for i in range(num_jobs):
        app = apps[int(rng.integers(len(apps)))]
        nb = int(nbs[int(rng.integers(len(nbs)))])
        gseed = int(rng.integers(2 ** 31 - 1))
        g = chameleon(app, nb, block_size, num_types=num_types, seed=gseed)
        g = with_ccr(g, ccr, gseed)
        jobs.append(Job(jid=i, tenant=int(rng.integers(num_tenants)),
                        arrival=float(times[i]), graph=g,
                        name=f"{app}_nb{nb}_s{gseed}"))
    return OpenLoopSource(jobs)
