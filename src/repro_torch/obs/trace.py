"""Chrome-trace-event export — Perfetto-loadable timelines (the port's copy
of the JAX package's ``repro.obs.trace``).

Two kinds of time live side by side:

  * **Simulated time** — per-unit task lanes from a :class:`SimResult`
    (:func:`sim_trace_events`) or a streams :class:`StreamResult`
    (:func:`stream_trace_events`).  Each processor unit is one ``tid`` lane;
    a width-``w`` task emits ``w`` complete events, one per occupied unit.
    Network transfers recorded by ``TransferTracker`` become their own link
    lanes (one per ``("up", src)`` / ``("down", dst)`` link).  Simulated
    seconds map to trace microseconds (×1e6).
  * **Wall-clock time** — registry spans (LP solve, canonical rounding,
    bucket execute, shard dispatch, contended fixpoint, benchmark phases)
    via :func:`wall_trace_events`, on their own ``pid`` with one lane per
    category.

Every emitted event is a ``"ph": "X"`` complete event (or an ``"M"``
metadata event naming processes/threads) carrying the chrome-trace-event
required keys ``ph``/``ts``/``pid``/``tid``/``name``; load a written file in
https://ui.perfetto.dev (or chrome://tracing) directly.
:func:`load_chrome_trace` validates those keys on read, so exports
round-trip through it in tests.
"""
from __future__ import annotations

import json
import os

from . import registry

__all__ = [
    "CHROME_REQUIRED_KEYS",
    "sim_trace_events", "stream_trace_events", "transfer_trace_events",
    "wall_trace_events", "export_chrome_trace", "load_chrome_trace",
]

#: Keys every chrome-trace event must carry (the loader enforces them).
CHROME_REQUIRED_KEYS = ("ph", "ts", "pid", "tid", "name")

#: Conventional pids: wall-clock spans, simulated engine lanes, stream lanes.
WALL_PID, SIM_PID, STREAM_PID = 0, 1, 2


def _meta(pid: int, name: str, tid: int = 0, kind: str = "process_name"):
    return {"ph": "M", "ts": 0, "pid": pid, "tid": tid, "name": kind,
            "args": {"name": name}}


def _unit_lanes(counts, names):
    """tid per (type, unit) plus thread-name metadata; returns
    (base offsets, total units, metadata events builder)."""
    base, total = [], 0
    for c in counts:
        base.append(total)
        total += int(c)
    return base, total


def _lane_meta(pid: int, counts, names) -> list[dict]:
    base, _ = _unit_lanes(counts, names)
    out = []
    for q, c in enumerate(counts):
        label = names[q] if names and q < len(names) else f"type{q}"
        for u in range(int(c)):
            tid = base[q] + u
            out.append(_meta(pid, f"{label}/{u}", tid, "thread_name"))
            out.append({"ph": "M", "ts": 0, "pid": pid, "tid": tid,
                        "name": "thread_sort_index",
                        "args": {"sort_index": tid}})
    return out


def sim_trace_events(result, machine, pid: int = SIM_PID) -> list[dict]:
    """Per-unit task lanes of a :class:`repro_torch.sim.engine.SimResult`.

    One ``tid`` lane per processor unit; a width-``w`` task is ``w``
    complete events sharing name/args — the multi-lane span Perfetto renders
    as one block per occupied unit.  Simulated time maps to microseconds.
    """
    sched = result.schedule
    counts = machine.counts
    names = getattr(machine, "names", None)
    base, _ = _unit_lanes(counts, names)
    events = [_meta(pid, f"sim:{result.scheduler}")]
    events += _lane_meta(pid, counts, names)
    n = len(sched.start)
    for j in range(n):
        q = int(sched.alloc[j])
        units = (sched.procs[j] if sched.procs is not None
                 else (int(sched.proc[j]),))
        w = int(sched.width[j]) if sched.width is not None else 1
        args = {"task": j, "rtype": q, "width": w,
                "scheduler": result.scheduler}
        if result.job_of is not None:
            args["job"] = int(result.job_of[j])
        for u in units:
            events.append({"ph": "X", "cat": "task", "name": f"t{j}",
                           "ts": float(sched.start[j]) * 1e6,
                           "dur": (float(sched.finish[j])
                                   - float(sched.start[j])) * 1e6,
                           "pid": pid, "tid": base[q] + int(u),
                           "args": args})
    return events


def transfer_trace_events(transfers, counts, pid: int = STREAM_PID,
                          names=None) -> list[dict]:
    """Link lanes for ``TransferTracker`` records.

    ``transfers`` is an iterable of ``(start, finish, links, size)`` where
    ``links`` are the tracker's link labels (e.g. ``("up", 0)``).  Each
    distinct link gets its own lane after the unit lanes; a transfer emits
    one event per link it occupies (it holds a share of both directions).
    """
    _, total = _unit_lanes(counts, names)
    lanes: dict[tuple, int] = {}
    events: list[dict] = []
    for start, fin, links, size in transfers:
        for link in links:
            key = tuple(link)
            if key not in lanes:
                tid = total + len(lanes)
                lanes[key] = tid
                label = "/".join(str(p) for p in key)
                events.append(_meta(pid, f"link:{label}", tid,
                                    "thread_name"))
                events.append({"ph": "M", "ts": 0, "pid": pid, "tid": tid,
                               "name": "thread_sort_index",
                               "args": {"sort_index": tid}})
            events.append({"ph": "X", "cat": "transfer", "name": "xfer",
                           "ts": float(start) * 1e6,
                           "dur": (float(fin) - float(start)) * 1e6,
                           "pid": pid, "tid": lanes[key],
                           "args": {"size": float(size)}})
    return events


def stream_trace_events(result, pid: int = STREAM_PID) -> list[dict]:
    """Per-unit task lanes (plus transfer link lanes) of a streams
    ``StreamResult`` (anything with ``machine`` and the same task and
    transfer records; the port's streams engine is ROADMAP A8)."""
    machine = result.machine
    counts = machine.counts
    names = getattr(machine, "names", None)
    base, _ = _unit_lanes(counts, names)
    events = [_meta(pid, f"stream:{result.policy}")]
    events += _lane_meta(pid, counts, names)
    for t in result.tasks:
        units = t.units if getattr(t, "units", ()) else (t.proc,)
        for u in units:
            events.append({"ph": "X", "cat": "task",
                           "name": f"j{t.jid}.t{t.task}",
                           "ts": float(t.start) * 1e6,
                           "dur": (float(t.finish) - float(t.start)) * 1e6,
                           "pid": pid, "tid": base[t.rtype] + int(u),
                           "args": {"jid": t.jid, "task": t.task,
                                    "tenant": t.tenant, "rtype": t.rtype,
                                    "width": t.width,
                                    "wait": float(t.wait)}})
    events += transfer_trace_events(getattr(result, "transfers", ()),
                                    counts, pid=pid, names=names)
    return events


def wall_trace_events(events=None, pid: int = WALL_PID) -> list[dict]:
    """Registry wall-clock spans as chrome events, timestamps relative to
    the earliest recorded span.

    One lane per span *family*: the explicit category when one was given,
    otherwise the first dotted component of the span name — so ``lp.solve``
    and ``lp.canonical_round`` share the ``lp`` lane while ``sim.*``,
    ``bench.*``, ``campaign.*``, ``stream.*`` each get their own.
    """
    evs = registry.wall_events() if events is None else list(events)
    if not evs:
        return []
    epoch = min(e["ts"] for e in evs)
    lanes: dict[str, int] = {}
    out = [_meta(pid, "wall-clock")]
    for e in evs:
        cat = e.get("cat", "wall")
        lane = e["name"].split(".", 1)[0] if cat == "wall" else cat
        if lane not in lanes:
            tid = len(lanes)
            lanes[lane] = tid
            out.append(_meta(pid, lane, tid, "thread_name"))
        out.append({"ph": "X", "cat": cat, "name": e["name"],
                    "ts": (e["ts"] - epoch) * 1e6, "dur": e["dur"] * 1e6,
                    "pid": pid, "tid": lanes[lane],
                    "args": dict(e.get("args", {}))})
    return out


def export_chrome_trace(path: str, events: list[dict]) -> str:
    """Write events as a chrome-trace JSON object (Perfetto-loadable);
    returns ``path``."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": list(events), "displayTimeUnit": "ms"}, f)
    return path


def load_chrome_trace(path: str) -> list[dict]:
    """Read a chrome-trace file back, validating the required event keys
    (``ph``/``ts``/``pid``/``tid``/``name``) on every event."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    for i, e in enumerate(events):
        missing = [k for k in CHROME_REQUIRED_KEYS if k not in e]
        if missing:
            raise ValueError(
                f"{path}: event {i} ({e.get('name', '?')!r}) missing "
                f"required chrome-trace keys {missing}")
    return events
