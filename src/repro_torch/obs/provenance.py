"""Allocation decision provenance — why each task got its (type, width).

Every allocator records, while the registry is enabled, one
:class:`DecisionRecord` per task: the fractional LP row it rounded from, the
tie-break the rounding took, the online rule that fired (ER-LS step 1 /
rule R2), and the communication price the decision pays — both the price
the LP was shown (``priced_comm``, contention-scaled for ``contention=True``
allocators, zero for comm-oblivious ones) and the crossing cost the engine
will actually charge into the task's readiness (``comm_price``).

The JAX package's ``provenance_diff``, ``explain_divergence`` and
``dump_decisions``, which read the records back, are not ported yet.
"""
from __future__ import annotations

import dataclasses

__all__ = ["DecisionRecord"]


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
