"""Per-tenant job tracking for open-system runs.

A stream run produces two record streams: one ``TaskRecord`` per committed
task (who ran where, when it arrived vs when it started — the queueing
signal) and one ``JobRecord`` per completed whole-DAG job (response time
against the job's isolation reference, the slowdown signal).  The
``TenantLedger`` accumulates both during a stream run, and
``repro_torch.streams.metrics`` aggregates them into the campaign tables.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np


@dataclasses.dataclass(frozen=True)
class TaskRecord:
    """One committed task: the unit the utilization/queue metrics see."""

    jid: int
    task: int          # local task id within its job's graph
    tenant: int
    rtype: int
    proc: int          # first unit; a moldable task holds ``width`` units
    arrival: float     # when the task became dispatchable (ready event time)
    start: float
    finish: float
    width: int = 1     # units occupied (the ``Decision`` width)
    units: tuple[int, ...] = ()   # the full unit set a width-w commit
    #                               claimed (may be non-contiguous); empty =
    #                               just ``proc`` (width-1).

    @property
    def wait(self) -> float:
        return self.start - self.arrival


@dataclasses.dataclass(frozen=True)
class JobRecord:
    """One completed job: the unit the response/slowdown metrics see.

    ``ref`` is the job's isolation reference — the universal makespan lower
    bound of its DAG on the (empty) machine, so
    ``response / ref >= 1`` for noise-free runs and bounded slowdown clamps
    the rest.
    """

    jid: int
    tenant: int
    name: str
    arrival: float
    start: float       # first task start
    finish: float      # last task finish
    ref: float
    n_tasks: int
    busy: tuple[float, ...]   # realized busy time contributed per type

    @property
    def response(self) -> float:
        return self.finish - self.arrival


class TenantLedger:
    """Accumulates task + job records during one stream run."""

    def __init__(self):
        self.jobs: list[JobRecord] = []
        self.tasks: list[TaskRecord] = []

    def add_task(self, rec: TaskRecord) -> None:
        self.tasks.append(rec)

    def add_job(self, rec: JobRecord) -> None:
        self.jobs.append(rec)

    @property
    def horizon(self) -> float:
        return max((t.finish for t in self.tasks), default=0.0)

    def by_tenant(self) -> dict[int, list[JobRecord]]:
        out: dict[int, list[JobRecord]] = defaultdict(list)
        for j in self.jobs:
            out[j.tenant].append(j)
        return dict(out)

    def responses(self) -> np.ndarray:
        return np.asarray([j.response for j in self.jobs])
