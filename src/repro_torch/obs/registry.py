"""The observability registry — counters, spans, decision records.

One process-global registry backs every layer's instrumentation:

  * **Counters** are always-on integers (``bump``/``counter_value``) — cheap
    enough to live inside jitted function bodies, where an increment runs
    once per XLA *trace* and therefore counts compiles
    (the JAX package's ``repro.sim.batch.trace_count``).
  * **Spans** are wall-clock intervals.  :func:`span` is the hot-path form:
    when the registry is disabled (the default) it returns a shared no-op
    context manager — the ``enabled()`` guard is the only cost.
  * **Decision records** (:class:`repro_torch.obs.provenance.DecisionRecord`) are
    appended by allocators via :func:`record_decision` while enabled.

Nothing here may change computation: the registry only observes.  Golden
schedule hashes must be bit-identical with the registry enabled or disabled
(``tests/test_obs.py`` pins this).
"""
from __future__ import annotations

import time
from typing import Any

__all__ = [
    "enabled", "enable", "disable", "capture", "reset",
    "bump", "counter_value", "set_counter", "counters",
    "span",
    "record_decision", "decision_records",
]


class _State:
    """Process-global mutable registry state."""

    __slots__ = ("enabled", "counters", "events", "decisions")

    def __init__(self):
        self.enabled = False
        self.counters: dict[str, int] = {}
        self.events: list[dict] = []
        self.decisions: list = []


_STATE = _State()


# ------------------------------------------------------------- enable/disable
def enabled() -> bool:
    """The zero-overhead guard: is the registry recording?"""
    return _STATE.enabled


def enable() -> None:
    """Start recording spans and decision records (counters are always
    on)."""
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


class capture:
    """Context manager: enable the registry for a block, restoring the prior
    enabled state on exit.  ``reset=True`` (default) clears events and
    decision records on entry so the block observes only itself."""

    def __init__(self, reset: bool = True):
        self._reset = reset

    def __enter__(self):
        self._was = _STATE.enabled
        if self._reset:
            reset()
        _STATE.enabled = True
        return _STATE

    def __exit__(self, *exc):
        _STATE.enabled = self._was
        return False


def reset(counters: bool = False) -> None:
    """Clear recorded spans and decision records; with ``counters=True``
    also zero every counter."""
    _STATE.events.clear()
    _STATE.decisions.clear()
    if counters:
        _STATE.counters.clear()


# ------------------------------------------------------------------- counters
def bump(name: str, n: int = 1) -> None:
    """Increment a counter (always on — safe inside jitted bodies, where it
    runs once per trace)."""
    _STATE.counters[name] = _STATE.counters.get(name, 0) + n


def counter_value(name: str) -> int:
    return _STATE.counters.get(name, 0)


def set_counter(name: str, value: int) -> None:
    _STATE.counters[name] = int(value)


def counters() -> dict[str, int]:
    """Snapshot of all counters."""
    return dict(_STATE.counters)


# ---------------------------------------------------------------------- spans
class Span:
    """A measured wall-clock interval; records itself on exit when the
    registry is enabled.  ``.dur`` holds the measured seconds after exit."""

    __slots__ = ("name", "cat", "args", "t0", "dur")

    def __init__(self, name: str, cat: str, args: dict[str, Any]):
        self.name, self.cat, self.args = name, cat, args
        self.t0 = 0.0
        self.dur = 0.0

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur = time.perf_counter() - self.t0
        if _STATE.enabled:
            _STATE.events.append({"name": self.name, "cat": self.cat,
                                  "ts": self.t0, "dur": self.dur,
                                  "args": self.args})
        return False


class _NoopSpan:
    """Shared do-nothing span for the disabled hot path."""

    __slots__ = ()
    dur = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


def span(name: str, cat: str = "wall", **args):
    """Hot-path span: a no-op singleton while disabled (zero overhead), a
    recording :class:`Span` while enabled."""
    if not _STATE.enabled:
        return _NOOP
    return Span(name, cat, args)


# ----------------------------------------------------------- decision records
def record_decision(rec) -> None:
    """Append a :class:`~repro_torch.obs.provenance.DecisionRecord` while enabled.
    Callers should guard the record *construction* with :func:`enabled`."""
    if _STATE.enabled:
        _STATE.decisions.append(rec)


def decision_records(scheduler: str | None = None) -> list:
    """Recorded decision records, optionally filtered by scheduler name."""
    if scheduler is None:
        return list(_STATE.decisions)
    return [r for r in _STATE.decisions if r.scheduler == scheduler]

