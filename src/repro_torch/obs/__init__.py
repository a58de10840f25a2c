"""``repro_torch.obs`` — counters, gauges, spans, Perfetto traces and
allocation decision provenance.

The port's copy of the JAX package's ``repro.obs``.  The registry
(:mod:`repro_torch.obs.registry`) is process-global and off by default:
:func:`enabled` is the zero-overhead guard every hot path checks.  Counters
are always on (the replay evaluator counts new replay shapes with them —
see ``repro_torch.sim.batch.trace_count``); spans and decision records are
recorded only while enabled (:func:`enable` / the :class:`capture` scope).

:mod:`repro_torch.obs.trace` exports simulated-time task/transfer lanes and
wall-clock span lanes as chrome-trace-event JSON, loadable in Perfetto;
:mod:`repro_torch.obs.provenance` captures per-task :class:`DecisionRecord`
evidence and diffs it across schedulers.
"""
from .provenance import (DecisionRecord, dump_decisions, explain_divergence,
                         provenance_diff)
from .registry import (bump, capture, counter_value, counters,
                       decision_records, disable, enable, enabled, gauges,
                       record_decision, reset, set_counter, set_gauge,
                       snapshot, span, timer, wall_events)
from .trace import (CHROME_REQUIRED_KEYS, export_chrome_trace,
                    load_chrome_trace, sim_trace_events, stream_trace_events,
                    transfer_trace_events, wall_trace_events)

__all__ = [
    # registry
    "enabled", "enable", "disable", "capture", "reset",
    "bump", "counter_value", "set_counter", "counters",
    "set_gauge", "gauges", "span", "timer", "wall_events",
    "record_decision", "decision_records", "snapshot",
    # trace
    "CHROME_REQUIRED_KEYS", "sim_trace_events", "stream_trace_events",
    "transfer_trace_events", "wall_trace_events", "export_chrome_trace",
    "load_chrome_trace",
    # provenance
    "DecisionRecord", "provenance_diff", "explain_divergence",
    "dump_decisions",
]
