"""repro_torch.sim.pipeline — the pipelined campaign executor.

The port of the JAX package's ``repro.sim.pipeline``.  The serial campaign
sweep (``sweep_suite_makespans`` with ``workers=1``) pays for the paper's
allocate/schedule separation one plan at a time: every LP solve, HEFT
insertion and ER-LS replay runs on the host before a single bucket is
replayed on the card.  This module overlaps the three phases instead:

  1. **Parallel plan construction** — ``scheduler.allocate(g, machine)``
     fans out over a worker pool (``REPRO_PLAN_WORKERS``, default
     ``os.cpu_count()``): a *process* pool for the HiGHS/LP-heavy adapters
     (``plan_pool = "process"``), threads for the pure-numpy ones and for
     those that launch on the card (``evo``).  Results are gathered in
     submission order, so schedules stay bit-identical to the serial path —
     ``workers=1`` *is* the serial path.

  2. **A content-addressed plan cache** — :func:`cached_allocate` keys a
     finished ``Plan`` by (TaskGraph fingerprint, scheduler name + config,
     platform, network knob), so the static/moldable/netbound sub-grids and
     the search's seed plans stop re-solving identical allocations across
     seeds and network models.  Hits and misses land in the always-on obs
     counters ``plan_cache.hits`` / ``plan_cache.misses``; the cache
     returns the *same* ``Plan`` object the solver produced, so recording
     on/off cannot perturb a schedule.

  3. **Host/device overlap** — every entry's shape bucket (its
     ``search_envelope``) is known *before* its plan is, so bucket
     membership is fixed up front and each bucket is dispatched the moment
     its last plan's noise grid is sampled.  Dispatch does not wait for the
     card: the bucket's inputs go from pinned host memory to the card on a
     side stream, the replay kernel launches on that stream, its result is
     copied back into pinned host memory and an event is recorded
     (``repro_torch.sim.batch._dispatch``).  The host then samples and
     builds the next bucket while the card replays this one, and blocks
     only in the final drain, which waits on the events in order.
     ``sim.pipeline.*`` spans time the stages and :func:`last_pipeline_stats`
     reports the measured ``overlap_frac``.

The JAX package's fourth stage, ``configure_xla_cache`` (a persistent XLA
compilation cache), has no counterpart: there is no XLA here, and the
port's kernels are already built once and cached on disk by source hash
(``repro_torch.kernels.build``).

Because buckets pad to the *envelope* (every legal plan of (g, machine)
fits), the pipeline replays one shape per bucket (``trace_count("bucket")``
counts it), and phantom/padding lanes cannot move a real makespan — the
pipelined sweep equals ``sweep_suite_makespans``'s serial route bit for
bit.  A bucket under a contended network (``maxmin_fair``) is priced while
its plan DAGs are built (``BatchedPlanDag.from_plans``): that fixpoint's
durations come back to the host before the bucket's replay is dispatched,
so each contended group waits for the card once.
"""
from __future__ import annotations

import dataclasses
import hashlib
import multiprocessing
import os
import threading
import time
from concurrent.futures import Executor, ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures.process import BrokenProcessPool

from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.dag import TaskGraph
from repro_torch.obs import registry as _obs
from repro_torch.platform import as_platform

from .engine import NoiseModel, Plan

if TYPE_CHECKING:
    import torch

__all__ = [
    "PipelineStats", "build_plans", "cached_allocate", "cached_solve",
    "clear_plan_cache", "graph_fingerprint", "last_pipeline_stats",
    "pipelined_sweep_makespans", "plan_cache_stats", "plan_fingerprint",
    "plan_workers", "pool_map",
]


# ------------------------------------------------------------------- knobs
def plan_workers() -> int:
    """Worker count for parallel plan construction: ``REPRO_PLAN_WORKERS``
    when set, else ``os.cpu_count()``.  ``1`` means build serially on the
    calling thread (bit-identical by construction, trivially)."""
    raw = os.environ.get("REPRO_PLAN_WORKERS", "").strip()
    if raw:
        return max(1, int(raw))
    return max(1, os.cpu_count() or 1)


# ------------------------------------------------------------ fingerprints
def _hash_update(h, value) -> None:
    if isinstance(value, np.ndarray):
        h.update(str((value.dtype.str, value.shape)).encode())
        h.update(np.ascontiguousarray(value).tobytes())
    else:
        h.update(repr(value).encode())
    h.update(b"|")


def graph_fingerprint(g: TaskGraph) -> str:
    """SHA-256 over every field of the (frozen) ``TaskGraph`` — array bytes
    with dtype/shape tags, scalars by repr.  Content-addressed: two graphs
    with equal arrays share a fingerprint regardless of identity.  Cached on
    the instance (graphs are immutable)."""
    fp = getattr(g, "_repro_fingerprint", None)
    if fp is not None:
        return fp
    h = hashlib.sha256()
    for f in dataclasses.fields(g):
        h.update(f.name.encode() + b"=")
        _hash_update(h, getattr(g, f.name))
    fp = h.hexdigest()
    object.__setattr__(g, "_repro_fingerprint", fp)
    return fp


def plan_fingerprint(plan: Plan) -> str:
    """SHA-256 of a plan's schedule content (alloc / proc / widths / per-proc
    sequences) — the golden-hash identity tests pin."""
    h = hashlib.sha256()
    _hash_update(h, np.asarray(plan.alloc))
    _hash_update(h, np.asarray(plan.proc))
    if plan.width is not None:
        _hash_update(h, np.asarray(plan.width))
    _hash_update(h, sorted((tuple(int(x) for x in k),
                            tuple(int(t) for t in v))
                           for k, v in plan.sequences.items()))
    return h.hexdigest()


def _platform_fingerprint(machine) -> str:
    return repr(as_platform(machine, warn=False))


_SIMPLE = (bool, int, float, str, bytes, type(None), tuple, frozenset)


def _scheduler_fingerprint(scheduler) -> str | None:
    """Stable (name + config) identity of a scheduler instance, or ``None``
    when the adapter opts out of caching (``cacheable = False``, e.g.
    ``FrozenPlanScheduler``) or carries config the fingerprint cannot see.

    Config is every simple public instance attribute plus dataclass configs
    by repr; adapters holding anything else (open files, arrays, callables
    beyond the name-carrying rule table) are refused rather than mis-keyed.
    """
    if not getattr(scheduler, "cacheable", True):
        return None
    parts = [type(scheduler).__name__, getattr(scheduler, "name", "?")]
    for k, v in sorted(vars(scheduler).items()):
        if k.startswith("_"):
            continue
        if isinstance(v, _SIMPLE):
            parts.append(f"{k}={v!r}")
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            parts.append(f"{k}={v!r}")
        elif callable(v):
            # name-carrying strategy hooks (greedy rule fns): the adapter
            # ``name`` already encodes which one — key on that
            parts.append(f"{k}=fn:{getattr(v, '__name__', '?')}")
        else:
            return None
    return "|".join(parts)


def plan_cache_key(g: TaskGraph, machine, scheduler,
                   network=None) -> tuple | None:
    """The content address of one allocation, or ``None`` when this
    scheduler cannot be cached.  ``network`` keys allocators that consume a
    network model at allocate time (today's adapters don't — contention
    awareness is scheduler *config* and already fingerprinted)."""
    sfp = _scheduler_fingerprint(scheduler)
    if sfp is None:
        return None
    net_key = None if network is None else getattr(
        network, "name", type(network).__name__)
    return (graph_fingerprint(g), sfp, _platform_fingerprint(machine), net_key)


# -------------------------------------------------------------- plan cache
_PLAN_CACHE: dict[tuple, Plan | None] = {}
_PLAN_CACHE_LOCK = threading.Lock()


def clear_plan_cache() -> None:
    """Drop every cached allocation (the hit/miss counters keep counting)."""
    with _PLAN_CACHE_LOCK:
        _PLAN_CACHE.clear()


def plan_cache_stats() -> dict[str, int]:
    """Cumulative ``plan_cache.hits`` / ``plan_cache.misses`` counter values
    plus the current entry count."""
    return {"hits": _obs.counter_value("plan_cache.hits"),
            "misses": _obs.counter_value("plan_cache.misses"),
            "entries": len(_PLAN_CACHE)}


def cached_allocate(scheduler, g: TaskGraph, machine, *,
                    network=None, cache: bool = True):
    """``scheduler.allocate(g, machine)`` through the content-addressed plan
    cache.  A hit returns the very ``Plan`` object the original solve
    produced (plans are immutable by convention), so results are bit-
    identical with the cache on or off; arrival-driven adapters
    (``allocate() -> None``) and uncacheable schedulers pass straight
    through.  Counters: ``plan_cache.hits`` / ``plan_cache.misses``."""
    key = plan_cache_key(g, machine, scheduler, network=network) if cache \
        else None
    if key is not None:
        with _PLAN_CACHE_LOCK:
            if key in _PLAN_CACHE:
                _obs.bump("plan_cache.hits")
                return _PLAN_CACHE[key]
    plan = scheduler.allocate(g, machine)
    if key is not None:
        _obs.bump("plan_cache.misses")
        if plan is not None:
            with _PLAN_CACHE_LOCK:
                _PLAN_CACHE[key] = plan
    return plan


def cached_solve(kind: str, g: TaskGraph, machine, solve, *, extra=()):
    """The plan cache for named deterministic plan builders that aren't
    adapter instances — e.g. the search's generation-0 seed plans
    (``lp_seed_plan``, one ``plan_for`` rollout per heuristic), which are
    re-solved identically for every search seed.  ``kind`` names the
    builder, ``extra`` carries its config knobs; ``solve()`` runs on a
    miss.  Same counters and same object-identity hit semantics as
    :func:`cached_allocate`."""
    key = ("solve", kind, graph_fingerprint(g),
           _platform_fingerprint(machine), tuple(extra))
    with _PLAN_CACHE_LOCK:
        if key in _PLAN_CACHE:
            _obs.bump("plan_cache.hits")
            return _PLAN_CACHE[key]
    plan = solve()
    _obs.bump("plan_cache.misses")
    if plan is not None:
        with _PLAN_CACHE_LOCK:
            _PLAN_CACHE[key] = plan
    return plan


# ------------------------------------------------- parallel plan construction
def _allocate_timed(scheduler, g, machine):
    """Worker-side allocate, returning (plan, solve_seconds).  Top-level so
    the process pool can pickle it by reference."""
    t0 = time.perf_counter()
    plan = scheduler.allocate(g, machine)
    return plan, time.perf_counter() - t0


def _pool_kind(scheduler) -> str:
    """Which pool an adapter's allocate belongs on: ``"process"`` for the
    HiGHS/LP-heavy solvers (sidestep the GIL), ``"thread"`` for pure-numpy
    ones and those that launch on the card (must stay in-process).
    ``REPRO_PLAN_POOL`` forces ``thread``/``process``/``serial`` for every
    adapter."""
    forced = os.environ.get("REPRO_PLAN_POOL", "").strip().lower()
    if forced in ("thread", "process", "serial"):
        return forced
    return getattr(scheduler, "plan_pool", "thread")


# The LP-heavy pool is process-based and *persistent*: started once at
# first use and reused by every later build, so the worker-startup cost is
# paid once per campaign, not once per sweep.  The ``forkserver`` context
# matters twice over: workers must never fork the parent directly (a
# process that holds a CUDA context cannot be forked safely) and must not
# re-import ``__main__`` unguarded — the forkserver is a cleanly exec'd
# interpreter that forks *itself*.  The workers plan on the host and never
# touch the card; what they import (the planners, this module) loads no
# torch, whose import alone takes seconds.
_PROCESS_POOL: ProcessPoolExecutor | None = None
_PROCESS_POOL_SIZE = 0
# flipped after a BrokenProcessPool (e.g. an unguarded/REPL __main__ that
# the start method cannot re-import): LP-heavy work then routes to the
# thread pool for the rest of the session instead of re-breaking per sweep
_PROCESS_POOL_DISABLED = False
# what the forkserver imports before it forks a worker: the default
# (``__main__``) and the modules a pickled planning task needs (no torch)
_PRELOAD = ["__main__", "repro_torch.sim.adapters", "repro_torch.sim.pipeline"]


def _process_pool(workers: int) -> ProcessPoolExecutor:
    global _PROCESS_POOL, _PROCESS_POOL_SIZE
    if _PROCESS_POOL is None or _PROCESS_POOL_SIZE < workers:
        if _PROCESS_POOL is not None:
            _PROCESS_POOL.shutdown(wait=False)
        if "forkserver" in multiprocessing.get_all_start_methods():
            ctx = multiprocessing.get_context("forkserver")
            # the server imports the planners once; each worker forks from
            # it with them loaded, instead of importing them itself
            ctx.set_forkserver_preload(_PRELOAD)
        else:
            ctx = multiprocessing.get_context("spawn")
        _PROCESS_POOL = ProcessPoolExecutor(max_workers=workers,
                                            mp_context=ctx)
        _PROCESS_POOL_SIZE = workers
    return _PROCESS_POOL


def _reset_process_pool(disable: bool = False) -> None:
    global _PROCESS_POOL, _PROCESS_POOL_SIZE, _PROCESS_POOL_DISABLED
    if _PROCESS_POOL is not None:
        _PROCESS_POOL.shutdown(wait=False)
    _PROCESS_POOL, _PROCESS_POOL_SIZE = None, 0
    if disable:
        _PROCESS_POOL_DISABLED = True


def pool_map(job, jobs: list[tuple], workers: int | None = None) -> list:
    """``job(*args)`` for every ``args`` of ``jobs``, over the planning
    process pool unless ``workers`` (default :func:`plan_workers`) is 1,
    obs recording is on or the pool broke earlier; the results in
    ``jobs``' order, the largest graphs (each ``args[0]``) submitted
    first.  ``job`` must be a module-level function of a module that loads
    no torch.  Every job of the campaign is deterministic, so a pooled run
    equals a serial one; a broken pool is counted (``plan_pool.broken``)
    and its jobs rerun here, as in :func:`build_plans`."""
    workers = plan_workers() if workers is None else max(1, int(workers))
    if workers == 1 or _obs.enabled() or _PROCESS_POOL_DISABLED:
        return [job(*args) for args in jobs]
    pool = _process_pool(workers)
    order = sorted(range(len(jobs)), key=lambda i: -jobs[i][0].n)
    futures = {i: pool.submit(job, *jobs[i]) for i in order}
    out = []
    for i in range(len(jobs)):
        try:
            out.append(futures[i].result())
        except BrokenProcessPool:
            _reset_process_pool(disable=True)
            _obs.bump("plan_pool.broken")
            out.append(job(*jobs[i]))
    return out


def build_plans(entries, *, workers: int | None = None, cache: bool = True,
                network=None) -> tuple[list, float]:
    """Allocate a plan for every ``(g, machine, scheduler)`` entry, fanning
    the solves over the worker pools, deduplicating through the plan cache
    (identical in-flight entries solve once), and returning
    ``(plans_in_entry_order, total_solve_seconds)``.

    Deterministic by construction: with a pool the solves are submitted
    largest graph first (so the longest do not start last), each result
    lands at its entry's index, every solver is deterministic, and cache
    hits return the original ``Plan`` object — so the result list is
    bit-identical for any ``workers`` and cache setting.  When obs recording is enabled the build
    runs serially in-process so span/decision ordering (LP provenance)
    stays deterministic too.  The longest single solve lands in the
    ``sim.pipeline.solve_max_s`` gauge: with a pool, the build stage can
    take no less.
    """
    workers = plan_workers() if workers is None else max(1, int(workers))
    if _obs.enabled():
        workers = 1
    results: list = [None] * len(entries)
    solves: list[float] = [0.0]

    # in-flight dedup: first entry per cache key solves, the rest alias it
    owner: dict[tuple, int] = {}
    alias: dict[int, int] = {}
    keys: list[tuple | None] = []
    for i, (g, machine, sched) in enumerate(entries):
        key = plan_cache_key(g, machine, sched, network=network) if cache \
            else None
        keys.append(key)
        if key is not None and key in owner:
            alias[i] = owner[key]
        elif key is not None:
            owner[key] = i

    if workers == 1:
        for i, (g, machine, sched) in enumerate(entries):
            if i in alias:
                _obs.bump("plan_cache.hits")
                results[i] = results[alias[i]]
                continue
            t0 = time.perf_counter()
            results[i] = cached_allocate(sched, g, machine, network=network,
                                         cache=cache)
            solves.append(time.perf_counter() - t0)
        _obs.set_gauge("sim.pipeline.solve_max_s", max(solves))
        return results, sum(solves)

    thread_pool: list[Executor] = []

    def pool_for(kind: str) -> Executor:
        if kind == "process" and not _PROCESS_POOL_DISABLED:
            return _process_pool(workers)
        if not thread_pool:
            thread_pool.append(ThreadPoolExecutor(max_workers=workers))
        return thread_pool[0]

    try:
        futures: dict[int, object] = {}
        # largest graphs first, so the longest solves do not start last
        # (each result still lands at its entry's index)
        order = sorted(range(len(entries)), key=lambda i: -entries[i][0].n)
        for i in order:
            g, machine, sched = entries[i]
            if i in alias:
                continue
            key = keys[i]
            if key is not None:
                with _PLAN_CACHE_LOCK:
                    if key in _PLAN_CACHE:
                        _obs.bump("plan_cache.hits")
                        results[i] = _PLAN_CACHE[key]
                        continue
            kind = _pool_kind(sched)
            if kind == "serial":
                plan, dt = _allocate_timed(sched, g, machine)
                solves.append(dt)
                results[i] = plan
            else:
                futures[i] = pool_for(kind).submit(
                    _allocate_timed, sched, g, machine)
        for i, fut in futures.items():
            try:
                plan, dt = fut.result()
            except BrokenProcessPool:
                # a spawn-hostile __main__ (stdin/REPL) or a killed worker:
                # solvers are deterministic, so recomputing inline keeps
                # bit-identity — the pool is dropped, not retried
                _reset_process_pool(disable=True)
                _obs.bump("plan_pool.broken")
                g_i, machine_i, sched_i = entries[i]
                plan, dt = _allocate_timed(sched_i, g_i, machine_i)
            solves.append(dt)
            results[i] = plan
            key = keys[i]
            if key is not None:
                _obs.bump("plan_cache.misses")
                if plan is not None:
                    with _PLAN_CACHE_LOCK:
                        _PLAN_CACHE[key] = plan
        for i, j in alias.items():
            _obs.bump("plan_cache.hits")
            results[i] = results[j]
    finally:
        for p in thread_pool:
            p.shutdown(wait=True)
    _obs.set_gauge("sim.pipeline.solve_max_s", max(solves))
    return results, sum(solves)


# ------------------------------------------------------ pipelined executor
@dataclasses.dataclass
class PipelineStats:
    """What one :func:`pipelined_sweep_makespans` run measured."""

    plans: int = 0
    buckets: int = 0
    workers: int = 1
    plan_build_s: float = 0.0    # summed solver seconds (all workers)
    solve_max_s: float = 0.0     # the longest single solve
    build_wall_s: float = 0.0    # wall seconds of the plan-building stage
    dispatch_s: float = 0.0      # host-side bucket build + async dispatch
    drain_s: float = 0.0         # blocking wait for the card at the end
    total_s: float = 0.0
    overlap_s: float = 0.0       # host work done with >= 1 bucket in flight
    overlap_frac: float = 0.0    # overlap_s / total_s
    cache_hits: int = 0
    cache_misses: int = 0


_LAST_STATS = PipelineStats()


def last_pipeline_stats() -> PipelineStats:
    """Stats of the most recent :func:`pipelined_sweep_makespans` call."""
    return _LAST_STATS


def _drain(in_flight, out: list) -> None:
    """Wait for each dispatched bucket in order and scatter its rows."""
    for _, idxs, flight in in_flight:
        ms = flight.result()   # waits for this bucket's copy back
        for row, j in enumerate(idxs):
            out[j] = ms[row]


def pipelined_sweep_makespans(entries, *, noise: NoiseModel = None, seeds=(),
                              sample_fn=None, floor_fn=None,
                              network=None, networks=None,
                              workers: int | None = None, cache: bool = True,
                              devices=None,
                              device: str | torch.device = "cuda"
                              ) -> list[np.ndarray]:
    """The pipelined drop-in for ``repro_torch.sim.batch.sweep_suite_makespans``:
    same ``(g, machine, scheduler)`` entries, same ``(S,)``-array-per-entry
    result, bit-identical values — built by the parallel/cached/overlapped
    executor instead of the serial loop.

    ``sample_fn(g, plan) -> (S, n)`` overrides the default noise grid
    (``sample_actual_batch(g, plan, noise, seeds)``); ``networks`` is an
    optional per-entry ``NetworkModel`` list (``network`` applies one model
    to every entry).  ``workers=1`` builds plans serially;
    ``workers=None`` reads ``REPRO_PLAN_WORKERS``.  ``device`` is where the
    replay runs (``"cuda"``: the kernel; ``"cpu"``: its plain version) and
    where contention is priced; ``devices`` overrides the list each
    bucket's plan axis splits over (``campaign_devices``).

    Buckets are keyed by :func:`search_envelope` — known from ``(g,
    machine)`` *before* the plan exists — so each bucket is dispatched the
    moment its last member's noise grid is sampled, without waiting for
    the card, and the card replays it while the host builds the next one.
    Padding to the envelope cannot move a real makespan (phantom lanes
    finish at 0), so values match the serial path exactly while the
    per-(g, machine) replay shape is shared with ``repro_torch.search``'s
    fixed-envelope evaluator.
    """
    # the replay side (torch) loads here, not with the module: a planning
    # worker imports this module for ``_allocate_timed`` alone
    from repro_torch.device import resolve_device

    from .batch import (BatchedPlanDag, _dispatch, bucket_times,
                        campaign_devices, sample_actual_batch,
                        search_envelope)

    global _LAST_STATS
    t_start = time.perf_counter()
    dev = resolve_device(device)
    devs = campaign_devices(dev) if devices is None else [
        resolve_device(d) for d in devices]
    stats = PipelineStats(plans=len(entries),
                          workers=plan_workers() if workers is None
                          else max(1, int(workers)))
    hits0 = _obs.counter_value("plan_cache.hits")
    misses0 = _obs.counter_value("plan_cache.misses")
    if not entries:
        _LAST_STATS = stats
        return []
    if networks is not None and len(networks) != len(entries):
        raise ValueError("networks and entries must align")
    if networks is None and network is not None:
        networks = [network] * len(entries)

    # bucket membership is fixed before any plan exists: the envelope key
    # depends only on (g, machine), so a bucket "closes" (and dispatches)
    # the moment its last member's plan is built
    keys = [search_envelope(g, machine) for g, machine, _ in entries]
    members: dict[tuple[int, int], list[int]] = {}
    for i, key in enumerate(keys):
        members.setdefault(key, []).append(i)
    stats.buckets = len(members)

    with _obs.span("sim.pipeline.build", plans=len(entries),
                   buckets=len(members), workers=stats.workers):
        plans, stats.plan_build_s = build_plans(
            entries, workers=workers, cache=cache, network=None)
    stats.build_wall_s = time.perf_counter() - t_start
    stats.solve_max_s = _obs.gauges()["sim.pipeline.solve_max_s"]
    for (g, machine, scheduler), plan in zip(entries, plans):
        if plan is None:
            raise ValueError(f"{scheduler.name} is arrival-driven; "
                             "the batch path needs a static plan")

    pending = {key: len(idxs) for key, idxs in members.items()}
    grids: dict[int, np.ndarray] = {}
    in_flight: list = []
    first_dispatch = None
    t_disp0 = time.perf_counter()
    for i, ((g, machine, _), plan) in enumerate(zip(entries, plans)):
        grids[i] = np.asarray(sample_fn(g, plan) if sample_fn is not None
                              else sample_actual_batch(g, plan, noise, seeds),
                              dtype=np.float64)
        key = keys[i]
        pending[key] -= 1
        if pending[key]:
            continue
        idxs = members[key]
        with _obs.span("sim.pipeline.dispatch", bucket=f"{key[0]}x{key[1]}",
                       plans=len(idxs)):
            items = [(entries[j][0], plans[j]) for j in idxs]
            bd = BatchedPlanDag.from_plans(
                items, pad_to=key,
                floors=([np.asarray(floor_fn(entries[j][0], plans[j]),
                                    dtype=np.float64) for j in idxs]
                        if floor_fn is not None else None),
                networks=([networks[j] for j in idxs]
                          if networks is not None else None),
                device=dev)
            if (bd.n_pad, bd.pred.shape[2]) != key:
                raise AssertionError(
                    f"plan escaped its envelope {key}: bucket padded to "
                    f"{(bd.n_pad, bd.pred.shape[2])}")
            tt = bucket_times([grids.pop(j) for j in idxs], bd.n_pad)
            # the card starts here; the host moves on without waiting
            flight = _dispatch(bd.order, bd.pred, bd.pred_delay, bd.floor,
                               tt, devs, "bucket")
        in_flight.append((key, idxs, flight))
        if first_dispatch is None:
            first_dispatch = time.perf_counter()
    t_drain0 = time.perf_counter()
    stats.dispatch_s = t_drain0 - t_disp0

    out: list[np.ndarray | None] = [None] * len(entries)
    with _obs.span("sim.pipeline.drain", buckets=len(in_flight)):
        _drain(in_flight, out)
    t_end = time.perf_counter()
    stats.drain_s = t_end - t_drain0
    stats.total_s = t_end - t_start
    stats.overlap_s = max(0.0, t_drain0 - first_dispatch) \
        if first_dispatch is not None else 0.0
    stats.overlap_frac = stats.overlap_s / stats.total_s if stats.total_s \
        else 0.0
    stats.cache_hits = _obs.counter_value("plan_cache.hits") - hits0
    stats.cache_misses = _obs.counter_value("plan_cache.misses") - misses0
    _obs.set_gauge("sim.pipeline.overlap_frac", stats.overlap_frac)
    _obs.set_gauge("sim.pipeline.plan_build_s", stats.plan_build_s)
    _LAST_STATS = stats
    return out  # type: ignore[return-value]
