"""First-class allocation objects: ``Platform``, ``Decision``, ``PoolState``.

The port's copy of the JAX package's ``repro.platform``, cut to what the
serving dispatcher needs:

  * ``Platform``  — typed resource pools (names, counts, per-type
    throughput).
  * ``Decision``  — one allocation decision is ``(type, width)``;
    ``width == 1`` is exactly the paper's rigid model, and
    :func:`as_decision` reads a bare type int as width 1.
  * ``PoolState`` — the committed-schedule view (per-type heaps of
    ``(free_time, proc_id)``).  Width-``w`` commits atomically claim the
    ``w`` earliest-free processors of a pool.

The counts-list deprecation shim (``as_platform``), the ``pack_decisions``
helpers, the named presets, ``PoolState.commit`` and ``busy_until`` port
with the simulation slice, which is their only user.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Iterable, Sequence

import numpy as np


def default_type_names(num_types: int) -> tuple[str, ...]:
    """Canonical pool names: the hybrid case is (cpu, gpu), larger platforms
    number their accelerator pools — one convention for traces and tables."""
    if num_types <= 0:
        return ()
    if num_types == 1:
        return ("cpu",)
    if num_types == 2:
        return ("cpu", "gpu")
    return ("cpu",) + tuple(f"gpu{i}" for i in range(1, num_types))


@dataclasses.dataclass(frozen=True)
class Platform:
    """Typed resource pools: ``counts[q]`` identical units of type ``q``.

    Attributes:
      counts:     units per pool.
      names:      pool names; filled with :func:`default_type_names` when
                  omitted, so every machine renders consistent type labels.
      throughput: per-type relative throughput multiplier (1.0 = reference).
                  Informational for cost models.
    """

    counts: tuple[int, ...]
    names: tuple[str, ...] | None = None
    throughput: tuple[float, ...] | None = None

    def __post_init__(self):
        object.__setattr__(self, "counts", tuple(int(c) for c in self.counts))
        if any(c < 0 for c in self.counts):
            raise ValueError("negative processor count")
        if self.names is None:
            object.__setattr__(self, "names",
                               default_type_names(len(self.counts)))
        else:
            object.__setattr__(self, "names", tuple(self.names))
            if len(self.names) != len(self.counts):
                raise ValueError("names and counts must align")
        if self.throughput is None:
            object.__setattr__(self, "throughput",
                               (1.0,) * len(self.counts))
        else:
            object.__setattr__(self, "throughput",
                               tuple(float(t) for t in self.throughput))
            if len(self.throughput) != len(self.counts):
                raise ValueError("throughput and counts must align")

    @property
    def num_types(self) -> int:
        return len(self.counts)

    @classmethod
    def from_counts(cls, counts: Iterable[int],
                    names: Sequence[str] | None = None) -> "Platform":
        """Adopt a ``counts`` list."""
        return cls(tuple(counts), names=tuple(names) if names else None)


@dataclasses.dataclass(frozen=True, order=True)
class Decision:
    """One allocation decision: resource *type* plus moldable *width*.

    ``width`` is the number of units of pool ``rtype`` the task occupies
    simultaneously.  ``width == 1`` is the paper's rigid model.
    """

    rtype: int
    width: int = 1

    def __post_init__(self):
        if self.width < 1:
            raise ValueError(f"width must be >= 1, got {self.width}")


def as_decision(obj) -> Decision:
    """Normalize a scheduler's per-task return value: a ``Decision``, a bare
    type int (read as ``width=1``) or a ``(type, width)`` pair."""
    if isinstance(obj, Decision):
        return obj
    if isinstance(obj, (int, np.integer)):
        return Decision(int(obj))
    if isinstance(obj, tuple) and len(obj) == 2:
        return Decision(int(obj[0]), int(obj[1]))
    raise TypeError(f"expected Decision, int or (type, width), got {obj!r}")


class PoolState:
    """The committed schedule over a platform's pools, as every online
    decision point sees it: per-type heaps of ``(free_time, proc_id)``."""

    def __init__(self, platform):
        p = platform if isinstance(platform, Platform) \
            else Platform.from_counts(platform)
        self.platform = p
        self.free = [[(0.0, pid) for pid in range(c)] for c in p.counts]
        for h in self.free:
            heapq.heapify(h)

    def earliest_idle(self, q: int, width: int = 1) -> float:
        """Earliest time ``width`` units of pool ``q`` are simultaneously
        free (``inf`` when the pool cannot ever fit the width)."""
        if width == 1:
            return self.free[q][0][0] if self.free[q] else np.inf
        if width > len(self.free[q]):
            return np.inf
        return heapq.nsmallest(width, self.free[q])[-1][0]

    def commit_wide(self, q: int, ready: float, p: float,
                    width: int = 1) -> tuple[tuple[int, ...], float, float]:
        """Atomically claim the ``width`` earliest-free units of pool ``q``
        from time ``max(ready, their horizons)`` for ``p`` time units.
        Returns ``(proc_ids, start, finish)``.
        """
        if width > len(self.free[q]):
            raise RuntimeError(
                f"width {width} exceeds pool {q} size {len(self.free[q])}")
        popped = [heapq.heappop(self.free[q]) for _ in range(width)]
        s = max(ready, popped[-1][0])
        f = s + p
        for _, pid in popped:
            heapq.heappush(self.free[q], (f, pid))
        return tuple(pid for _, pid in popped), s, f


__all__ = ["Platform", "Decision", "PoolState", "as_decision",
           "default_type_names"]
