"""``repro_torch.obs`` — counters, spans and allocation decision provenance.

The port's copy of the parts of the JAX package's ``repro.obs`` that the
scheduling core and the simulator call.  The registry
(:mod:`repro_torch.obs.registry`) is process-global and off by default:
:func:`enabled` is the zero-overhead guard every hot path checks.  Counters
are always on; spans and decision records are recorded only while enabled
(:func:`enable` / the :class:`capture` scope).
:mod:`repro_torch.obs.provenance` holds the per-task :class:`DecisionRecord`
the allocators record.  The JAX package's gauges, ``timer``,
``wall_events``, ``snapshot``, the provenance diff and the chrome-trace
export (``repro.obs.trace``) are not ported yet: nothing in the port reads
them.
"""
from .provenance import DecisionRecord
from .registry import (bump, capture, counter_value, counters,
                       decision_records, disable, enable, enabled,
                       record_decision, reset, set_counter, span)

__all__ = [
    # registry
    "enabled", "enable", "disable", "capture", "reset",
    "bump", "counter_value", "set_counter", "counters", "span",
    "record_decision", "decision_records",
    # provenance
    "DecisionRecord",
]
