"""First-class allocation objects: ``Platform``, ``Decision``, ``PoolState``.

The port's copy of the JAX package's ``repro.platform``:

  * ``Platform``  — typed resource pools (names, counts, per-type
    throughput).  ``repro_torch.sim.engine.Machine`` is a ``Platform``
    subclass, and every scheduler entry point accepts either a ``Platform``
    or (via the :func:`as_platform` deprecation shim) a bare ``counts``
    list.
  * ``Decision``  — one allocation decision is ``(type, width)``: *moldable*
    tasks may occupy ``width`` units of one pool and shrink by the task's
    speedup curve (``TaskGraph.speedup``).  ``width == 1`` is exactly the
    paper's rigid model, and :func:`as_decision` reads a bare type int as
    width 1.
  * ``PoolState`` — the committed-schedule view (per-type heaps of
    ``(free_time, proc_id)``) shared by the simulation engine, the pure-core
    online loop and the serving dispatcher.  Width-``w`` commits atomically
    claim the ``w`` earliest-free processors of a pool.

Determinism note: with ``width == 1`` every code path below performs the
heap operations of the reference in the same order, so seeded schedules
match it bit for bit (``tests/test_torch_sim.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
import warnings
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
                  Informational for cost models; the scheduling core reads
                  per-task times from ``TaskGraph.proc`` directly.
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

    # ------------------------------------------------------------ properties
    @property
    def num_types(self) -> int:
        return len(self.counts)

    @property
    def total(self) -> int:
        return sum(self.counts)

    def index(self, name: str) -> int:
        """Pool index of a type name (raises ``ValueError`` when unknown)."""
        return self.names.index(name)

    # --------------------------------------------------------- constructors
    @classmethod
    def hybrid(cls, m: int, k: int) -> "Platform":
        """The paper's (m CPUs, k GPUs) platform."""
        return cls((m, k))

    @classmethod
    def from_counts(cls, counts: Iterable[int],
                    names: Sequence[str] | None = None) -> "Platform":
        """Adopt a legacy ``counts`` list (the pre-v2 machine encoding)."""
        return cls(tuple(counts), names=tuple(names) if names else None)

    def to_counts(self) -> list[int]:
        """The legacy ``counts``-list view (``from_counts``'s inverse)."""
        return list(self.counts)

    def state(self) -> "PoolState":
        """A fresh committed-schedule state over this platform's pools."""
        return PoolState(self)


#: Call sites (file, line) that already emitted a deprecation warning.  A
#: campaign loops one entry point over thousands of tasks; warning once per
#: *call site* keeps the signal (every distinct legacy usage is reported)
#: without the spam (one line per site per process, whatever the warning
#: filters say — pytest's ``always`` filter included).
_WARNED_CALLSITES: set[tuple[str, int]] = set()


def _reset_deprecation_registry() -> None:
    """Forget which call sites warned (test isolation helper)."""
    _WARNED_CALLSITES.clear()


def _warn_deprecated_once(message: str, stacklevel: int) -> None:
    """``warnings.warn`` deduplicated per shim call site.

    The registry key is the code line that invoked the deprecated shim —
    for a public entry point that still accepts legacy arguments that is
    the entry point itself, so a campaign looping it over thousands of
    tasks emits exactly one warning per entry point per process."""
    import sys
    try:
        fr = sys._getframe(2)     # caller of the shim (as_platform's caller)
        site = (fr.f_code.co_filename, fr.f_lineno)
    except ValueError:            # shallower stack than expected
        site = ("<unknown>", 0)
    if site in _WARNED_CALLSITES:
        return
    _WARNED_CALLSITES.add(site)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel + 1)


def as_platform(obj, *, warn: bool = True) -> Platform:
    """Normalize a machine argument: ``Platform`` (or subclass) passes
    through; a bare counts sequence — the deprecated pre-v2 encoding — is
    adopted via :meth:`Platform.from_counts`, emitting a
    ``DeprecationWarning`` once per call site unless ``warn=False``
    (internal call sites that already warned once).
    """
    if isinstance(obj, Platform):
        return obj
    if isinstance(obj, (list, tuple, np.ndarray)):
        if warn:
            _warn_deprecated_once(
                "passing a bare counts list is deprecated; pass a "
                "repro_torch.platform.Platform (e.g. Platform.hybrid(m, k))",
                stacklevel=3)
        return Platform.from_counts(int(c) for c in obj)
    raise TypeError(f"expected Platform or counts sequence, got {type(obj)!r}")


# ------------------------------------------------------------------ decision
@dataclasses.dataclass(frozen=True, order=True)
class Decision:
    """One allocation decision: resource *type* plus moldable *width*.

    ``width`` is the number of units of pool ``rtype`` the task occupies
    simultaneously; its processing time shrinks by the task's speedup curve
    (``TaskGraph.proc_w``).  ``width == 1`` is the paper's rigid model.
    """

    rtype: int
    width: int = 1

    def __post_init__(self):
        if self.width < 1:
            raise ValueError(f"width must be >= 1, got {self.width}")


def as_decision(obj) -> Decision:
    """Normalize a scheduler's per-task return value.

    Accepts a ``Decision``, a bare type int (the deprecated pre-v2 protocol,
    read as ``width=1``) or a ``(type, width)`` pair — so every legacy
    ``on_task_arrival``/``assign`` implementation keeps working unchanged.
    """
    if isinstance(obj, Decision):
        return obj
    if isinstance(obj, (int, np.integer)):
        return Decision(int(obj))
    if isinstance(obj, tuple) and len(obj) == 2:
        return Decision(int(obj[0]), int(obj[1]))
    raise TypeError(f"expected Decision, int or (type, width), got {obj!r}")


def pack_decisions(decisions: Sequence[Decision]
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(alloc, width) arrays from per-task ``Decision`` records — the
    vectorized view the schedulers and the batch path compute with."""
    alloc = np.asarray([d.rtype for d in decisions], dtype=np.int32)
    width = np.asarray([d.width for d in decisions], dtype=np.int32)
    return alloc, width


def decisions_of(alloc: np.ndarray,
                 width: np.ndarray | None = None) -> tuple[Decision, ...]:
    """Per-task ``Decision`` records from (alloc, width) arrays
    (``pack_decisions``'s inverse; ``width=None`` reads as all-ones)."""
    alloc = np.asarray(alloc)
    if width is None:
        return tuple(Decision(int(q)) for q in alloc)
    return tuple(Decision(int(q), int(w)) for q, w in zip(alloc, width))


# ----------------------------------------------------------- committed state
class PoolState:
    """The committed schedule over a platform's pools, as every online
    decision point sees it: per-type heaps of ``(free_time, proc_id)``.

    One implementation serves the simulation engine (``MachineState`` is a
    subclass), the pure-core online loop, the streams engine and the serving
    dispatcher — the ``counts``/``Machine``/``MachineState`` construction
    triplication this object replaced.
    """

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

    def busy_until(self, q: int) -> np.ndarray:
        """Sorted (ascending) commitment horizon of every type-q processor —
        the state a simulation-in-the-loop rollout conditions on."""
        return np.sort([f for f, _ in self.free[q]])

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

    def commit(self, q: int, ready: float, p: float) -> tuple[int, float, float]:
        """Width-1 commit (the historical protocol): returns the single
        claimed processor id."""
        if not self.free[q]:
            raise RuntimeError(f"no processors of type {q}")
        pids, s, f = self.commit_wide(q, ready, p, 1)
        return pids[0], s, f


#: Named platform presets — the registry ``benchmarks.run --list`` renders.
PLATFORMS: dict[str, Platform] = {
    "hybrid_4x1": Platform.hybrid(4, 1),
    "hybrid_8x2": Platform.hybrid(8, 2),
    "hybrid_16x4": Platform.hybrid(16, 4),
    "hybrid_64x8": Platform.hybrid(64, 8),
    "tri_16x4x2": Platform((16, 4, 2)),
}


__all__ = [
    "Platform", "Decision", "PoolState", "PLATFORMS", "as_platform",
    "as_decision", "pack_decisions", "decisions_of", "default_type_names",
]
