"""repro_torch.streams — multi-tenant open-system workload streams.

The port's copy of the JAX package's ``repro.streams``: whole DAG jobs from
many tenants arriving over time on one shared machine, and what each tenant
experiences.

  * ``arrivals``  — seeded arrival processes (Poisson, bursty MMPP,
                    closed-loop think time) emitting whole-DAG jobs drawn
                    from the scenario families;
  * ``engine``    — the open-system event loop: ready-driven irrevocable
                    commits across all in-flight jobs on one shared
                    ``MachineState``, with job-completion feedback;
  * ``tenants`` / ``metrics`` — per-tenant job tracking and open-system
                    metrics (response time, bounded slowdown p50/p95,
                    per-type utilization, queue lengths over time);
  * ``replay``    — ESTEE-format workflow traces and the paper's Chameleon
                    workloads as timed job streams;
  * ``policy``    — every ``repro_torch.sim`` adapter as a stream policy,
                    plus ``SimInTheLoop``: allocation search by
                    state-conditioned rollouts, replayed on the card by the
                    replay kernel, degrading to plain ER-LS under a latency
                    budget.

Every module but ``policy`` is host code and imports no torch; the policy
names load ``policy`` (and with it the replay evaluator) when first asked
for, so a planner that imports the stream engine starts without torch.

Entry points::

    from repro_torch.sim.engine import Machine
    from repro_torch.streams import (JobFactory, PoissonProcess, open_stream,
                                     make_policy, run_stream)

    src = open_stream(PoissonProcess(0.05), JobFactory(), num_jobs=20, seed=0)
    res = run_stream(src, Machine.hybrid(8, 2), make_policy("sim_in_the_loop"))
    print(res.tenant_table(), res.utilization())
"""
from .arrivals import (DEFAULT_JOB_PARAMS, ClosedLoopSource, Job, JobFactory,
                       MMPPProcess, OpenLoopSource, PoissonProcess,
                       open_stream)
from .engine import StreamResult, run_stream
from .metrics import (bounded_slowdown, job_slowdowns, mean_queue_length,
                      queue_length_series, tenant_summary, utilization)
from .replay import chameleon_stream, replay_estee
from .tenants import JobRecord, TaskRecord, TenantLedger

_POLICY = ("COMM_CANDIDATES", "DEFAULT_CANDIDATES", "SEARCH_CANDIDATES",
           "AdapterPolicy", "SimInTheLoop", "StreamPolicy", "make_policy")

__all__ = [
    "DEFAULT_JOB_PARAMS", "ClosedLoopSource", "Job", "JobFactory",
    "MMPPProcess", "OpenLoopSource", "PoissonProcess", "open_stream",
    "StreamResult", "run_stream", "bounded_slowdown", "job_slowdowns",
    "mean_queue_length", "queue_length_series", "tenant_summary",
    "utilization", "AdapterPolicy", "SimInTheLoop", "StreamPolicy",
    "DEFAULT_CANDIDATES", "COMM_CANDIDATES", "SEARCH_CANDIDATES",
    "make_policy", "chameleon_stream", "replay_estee", "JobRecord",
    "TaskRecord", "TenantLedger",
]


def __getattr__(name: str):
    if name in _POLICY:
        from . import policy
        return getattr(policy, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
