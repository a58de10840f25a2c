"""Allocation decision provenance — why each task got its (type, width).

Every allocator records, while the registry is enabled, one
:class:`DecisionRecord` per task: the fractional LP row it rounded from, the
tie-break the rounding took, the online rule that fired (ER-LS step 1 /
rule R2), and the communication price the decision pays — both the price
the LP was shown (``priced_comm``, contention-scaled for ``contention=True``
allocators, zero for comm-oblivious ones) and the crossing cost the engine
will actually charge into the task's readiness (``comm_price``).

:func:`provenance_diff` pairs two schedulers' records task-by-task and
returns the tasks where the decisions diverge, each with both sides'
evidence — this is how a campaign loss becomes attributable:
:func:`explain_divergence` runs it for ``cahlp_ols`` vs ``hlp_ols`` on a
graph (the netbound story) in one call.
"""
from __future__ import annotations

import dataclasses
import json
import os

from . import registry

__all__ = [
    "DecisionRecord", "provenance_diff", "explain_divergence",
    "dump_decisions",
]


@dataclasses.dataclass(frozen=True)
class DecisionRecord:
    """One task's allocation decision and the evidence behind it.

    Attributes:
      scheduler:   adapter name that made the decision.
      task:        task id.
      rtype:       resource type chosen.
      width:       units occupied (moldable decisions; 1 otherwise).
      x_frac:      the task's fractional LP row, rounded to 6 digits —
                   ``(x_cpu,)`` for the hybrid LP, the full (type[, width])
                   row for grid LPs; ``None`` for non-LP deciders.
      tie_break:   how the rounding resolved the row — ``"threshold:cpu"`` /
                   ``"threshold:gpu"`` (hybrid ``x >= 0.5``), ``"argmax"``,
                   or ``"argmax_tie:min_time"`` when several entries tied
                   and the shortest processing time won.
      rule:        online rule that fired (``"step1:gpu"``, ``"r2:cpu"``,
                   ``"r2:gpu"`` for ER-LS); ``None`` for LP allocators.
      comm_price:  realized crossing cost charged into this task's readiness
                   under the final allocation (sum of incoming cross-type
                   edge transfer costs).
      priced_comm: the comm term the *LP objective* saw for those edges —
                   zero for comm-oblivious allocators, contention-scaled by
                   the expected-link-load prior for ``contention=True``.
    """

    scheduler: str
    task: int
    rtype: int
    width: int = 1
    x_frac: tuple[float, ...] | None = None
    tie_break: str | None = None
    rule: str | None = None
    comm_price: float = 0.0
    priced_comm: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def provenance_diff(a, b) -> list[dict]:
    """Tasks where two schedulers' :class:`DecisionRecord` lists disagree.

    Records are paired by task id; a disagreement is a differing
    ``(rtype, width)``.  Each returned entry carries both records plus a
    one-line ``why`` string quoting each side's LP row and comm prices.
    """
    by_a = {r.task: r for r in a}
    by_b = {r.task: r for r in b}
    out = []
    for j in sorted(set(by_a) & set(by_b)):
        ra, rb = by_a[j], by_b[j]
        if (ra.rtype, ra.width) == (rb.rtype, rb.width):
            continue
        out.append({
            "task": j,
            "a": ra.to_dict(), "b": rb.to_dict(),
            "why": (f"task {j}: {_explain(ra)} vs {_explain(rb)}"),
        })
    return out


def _explain(r: DecisionRecord) -> str:
    how = r.rule or r.tie_break or "direct"
    x = "" if r.x_frac is None else f" x={list(r.x_frac)}"
    return (f"{r.scheduler} -> (type {r.rtype}, w {r.width}) via {how}{x}"
            f" [comm paid {r.comm_price:.4g}, LP priced {r.priced_comm:.4g}]")


def explain_divergence(g, machine, sched_a: str = "cahlp_ols",
                       sched_b: str = "hlp_ols", **kw) -> list[dict]:
    """Allocate ``g`` with two adapters under a capture scope and diff their
    decision provenance — e.g. where does comm-aware allocation disagree
    with oblivious HLP on a netbound graph, and what comm price explains it.
    """
    from repro_torch.sim.adapters import make_scheduler

    with registry.capture():
        make_scheduler(sched_a, **kw).allocate(g, machine)
        make_scheduler(sched_b, **kw).allocate(g, machine)
        ra = registry.decision_records(scheduler=sched_a)
        rb = registry.decision_records(scheduler=sched_b)
        return provenance_diff(ra, rb)


def dump_decisions(path: str, records=None) -> str:
    """Write decision records (default: the registry's) as a JSON list
    alongside a trace; returns ``path``."""
    recs = registry.decision_records() if records is None else list(records)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump([r.to_dict() for r in recs], f)
    return path
