"""Pluggable network models: how cross-type data transfers cost time.

The paper charges a *fixed point-to-point latency* on every cross-type
edge — adequate when transfers never coincide, wrong the moment two of
them share a link.  This module makes the network a first-class, swappable
ingredient of the simulation (the ESTEE design: tasks produce sized data
objects that flow through a ``NetworkModel``):

  * ``instant``       — transfers are free; executing a comm-carrying graph
                        under it reproduces the paper's ``ccr=0`` model.
  * ``fixed_latency`` — today's model, bit-for-bit: each cross-type edge
                        delays its consumer by ``g.comm[e]`` regardless of
                        what else is in flight.  ``simulate(network=None)``
                        and ``simulate(network=FixedLatencyNetwork())`` are
                        byte-identical (golden-tested).
  * ``maxmin_fair``   — fluid-flow contention: every resource type owns one
                        full-duplex link of capacity ``bandwidth``; a
                        transfer from type a to type b occupies a's uplink
                        and b's downlink, and concurrent transfers share
                        each link under **max-min fairness** (progressive
                        filling).  A lone transfer of the default-sized
                        object (``size = comm × bandwidth``) takes exactly
                        its fixed-latency time, so contention-free replays
                        agree with ``fixed_latency`` and congestion only
                        ever *adds* delay.

Data objects: ``TaskGraph`` optionally carries per-edge ``size`` (bytes)
and ``out_id`` (which produced output the edge ships).  Two edges with the
same ``out_id`` reuse one object — contended models send it across a given
type boundary **once** (output caching), not once per consumer edge.
Graphs without sizes default every edge to ``comm × bandwidth`` so the two
parameterizations describe the same traffic.

Three consumers of a model:

  * the exact event engine (``engine._execute_plan_network``) re-solves all
    in-flight transfer rates at every start/finish event via
    :func:`maxmin_rates`;
  * the irrevocable-commit loops (``repro_torch.streams``) use the causal
    :class:`TransferTracker` — earlier transfers' finish times are frozen
    when a new one starts (first-come-frozen fluid approximation), which
    keeps decisions causal at the cost of slightly optimistic sharing;
  * the batched replay path prices each plan through the same fixed-start
    max-min fluid fixpoint, evaluated either by the plain-numpy reference
    (:func:`contended_plan_delays`, the oracle) or — the default — by the
    whole-bucket fixpoint of ``repro_torch.sim.batch`` (one launch of the
    CUDA kernel ``kernels/csrc/contention.cu`` per padded shape on the card;
    its plain float64 torch version, built on :func:`fluid_finishes_ref`,
    on the CPU).  :func:`set_contention_kernel` switches the two; they
    agree to rtol 1e-6.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dag import TaskGraph
from repro_torch.kernels.contention.ref import fluid_finishes_ref
from repro_torch.obs import registry as _obs

_EPS = 1e-12


# ----------------------------------------------------------- max-min solver
def maxmin_rates(flow_links: list[tuple], capacity: float = 1.0) -> np.ndarray:
    """(F,) max-min fair rates for flows over unit-capacity links.

    ``flow_links[f]`` is the tuple of (hashable) links flow ``f`` occupies;
    every link has capacity ``capacity``.  Progressive filling: all unfrozen
    rates rise together until some link saturates, flows crossing a
    saturated link freeze at the waterline, repeat.  Invariants (property-
    tested): per-link sums never exceed capacity, and every flow gets at
    least its fair share ``min_l capacity / n_l`` over the links it crosses.
    """
    F = len(flow_links)
    rates = np.zeros(F)
    if not F:
        return rates
    unfrozen = set(range(F))
    used: dict = {}
    on_link: dict = {}
    for f, links in enumerate(flow_links):
        for l in links:
            used.setdefault(l, 0.0)
            on_link.setdefault(l, set()).add(f)
    while unfrozen:
        inc = min((capacity - used[l]) / len(on_link[l] & unfrozen)
                  for l in used if on_link[l] & unfrozen)
        inc = max(inc, 0.0)
        for f in unfrozen:
            rates[f] += inc
        saturated = []
        for l in used:
            live = on_link[l] & unfrozen
            if live:
                used[l] += inc * len(live)
                if used[l] >= capacity - _EPS:
                    saturated.append(l)
        froze = set()
        for l in saturated:
            froze |= on_link[l] & unfrozen
        if not froze:       # numerical guard: freeze everything remaining
            break
        unfrozen -= froze
    return rates


# -------------------------------------------------------------- model layer
class NetworkModel:
    """Base interface every network model implements.

    ``contended`` models need the fluid transfer machinery; non-contended
    ones reduce to per-edge delay arrays and ride the historical replay
    path unchanged.
    """

    name = "network"
    contended = False
    bandwidth = 1.0

    # --- non-contended path -------------------------------------------------
    def plan_delays(self, g: TaskGraph, alloc: np.ndarray) -> np.ndarray:
        """(e,) per-edge delay charged at replay under this model."""
        raise NotImplementedError

    def effective_comm(self, g: TaskGraph) -> np.ndarray:
        """(e,) potential per-edge cost an arrival-driven readiness check
        charges when a candidate edge crosses (non-contended models only)."""
        return g.comm

    def validation_delays(self, g: TaskGraph, alloc: np.ndarray) -> np.ndarray:
        """(e,) per-edge *lower bound* on data delay — what feasibility
        checks may safely assert (``start[j] >= finish[i] + bound``)."""
        return self.plan_delays(g, alloc)

    # --- contended path -----------------------------------------------------
    def links_of(self, src_type: int, dst_type: int) -> tuple:
        """The links a ``src_type -> dst_type`` transfer occupies: the
        source type's uplink and the destination type's downlink (opposite
        directions never contend on a full-duplex link)."""
        return (("up", int(src_type)), ("down", int(dst_type)))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"{type(self).__name__}()"


class InstantNetwork(NetworkModel):
    """Transfers are free — the paper's communication-free (ccr=0) model,
    applied at *execution* time regardless of what the graph carries."""

    name = "instant"

    def plan_delays(self, g, alloc):
        return np.zeros(g.num_edges)

    def effective_comm(self, g):
        return np.zeros(g.num_edges)


class FixedLatencyNetwork(NetworkModel):
    """Today's model, bit-for-bit: cross-type edges pay ``g.comm[e]`` as a
    fixed delay, contention-free.  ``simulate(network=None)`` is this."""

    name = "fixed_latency"

    def plan_delays(self, g, alloc):
        return g.edge_delays(alloc)


@dataclasses.dataclass(frozen=True)
class MaxMinFairNetwork(NetworkModel):
    """Fluid-flow contention with max-min fair link sharing (ESTEE-style).

    Each resource type owns one full-duplex link of capacity ``bandwidth``;
    a ``a -> b`` transfer ships its data object over a's uplink and b's
    downlink at the max-min fair rate among all concurrent transfers.  The
    default object size is ``comm × bandwidth`` (see
    ``TaskGraph.data_sizes``), so an uncontended transfer takes exactly its
    fixed-latency time and this model is a pure *pessimization* of
    ``fixed_latency`` — never faster, measurably slower where transfers
    actually collide.
    """

    bandwidth: float = 1.0
    name = "maxmin_fair"
    contended = True

    def __post_init__(self):
        if not self.bandwidth > 0.0:
            raise ValueError(f"bandwidth must be > 0, got {self.bandwidth}")

    def plan_delays(self, g, alloc):
        raise RuntimeError("maxmin_fair is contended — delays depend on "
                           "what else is in flight; use the engine's fluid "
                           "replay or contended_plan_delays")

    def validation_delays(self, g, alloc):
        # every transfer starts no earlier than its producer's finish and
        # moves at most `bandwidth`, so size/bandwidth lower-bounds the lag
        if not g.num_edges:
            return np.zeros(0)
        a = np.asarray(alloc, dtype=np.int64)
        cross = a[g.edges[:, 0]] != a[g.edges[:, 1]]
        return np.where(cross, g.data_sizes(self.bandwidth) / self.bandwidth,
                        0.0)


NETWORKS = {
    "instant": InstantNetwork,
    "fixed_latency": FixedLatencyNetwork,
    "maxmin_fair": MaxMinFairNetwork,
}


def make_network(name: str, **kw) -> NetworkModel:
    """Factory over the model registry (mirrors ``make_scheduler``)."""
    if name not in NETWORKS:
        raise ValueError(f"unknown network model {name!r}; "
                         f"have {sorted(NETWORKS)}")
    return NETWORKS[name](**kw)


# ---------------------------------------------------- causal stream tracker
class TransferTracker:
    """First-come-frozen fluid tracker for irrevocable-commit event loops.

    The exact fluid model re-solves *all* in-flight rates whenever a
    transfer starts or finishes — which retroactively moves finish times
    the stream engine may already have committed against.  This tracker
    keeps decisions causal: a registered transfer's finish time is frozen
    at registration, and a *new* transfer moves at
    ``min_l capacity / (n_l(t) + 1)`` through the piecewise-constant load
    profile the frozen transfers leave behind.  Slightly optimistic for the
    old flows, slightly pessimistic for the new one; exact whenever
    transfers don't overlap.

    ``estimate`` answers "when would this transfer finish?" without
    registering it — clone the tracker to price multi-input candidates.
    """

    def __init__(self, network: NetworkModel):
        self.network = network
        self._active: list[tuple[float, float, tuple]] = []  # (start, fin, links)
        #: (start, fin, links, size) per registered transfer while the obs
        #: registry is enabled — the Perfetto link-lane source
        #: (the JAX package's ``repro.obs.trace.transfer_trace_events``).  Pure log: never
        #: read back by the fluid model.
        self.log: list[tuple[float, float, tuple, float]] = []

    def clone(self) -> "TransferTracker":
        t = TransferTracker(self.network)
        t._active = list(self._active)
        return t

    def _finish_time(self, now: float, size: float, links: tuple) -> float:
        cap = self.network.bandwidth
        if size <= 0.0:
            return now
        horizon = sorted({fin for _, fin, L in self._active
                          if fin > now and (set(L) & set(links))})
        t0, remaining = now, float(size)
        for seg_end in horizon + [np.inf]:
            loads = [sum(1 for _, fin, L in self._active
                         if fin > t0 + _EPS and l in L)
                     for l in links]
            rate = min(cap / (nl + 1) for nl in loads)
            if t0 + remaining / rate <= seg_end + _EPS:
                return t0 + remaining / rate
            remaining -= rate * (seg_end - t0)
            t0 = seg_end
        raise AssertionError("unreachable")  # pragma: no cover

    def estimate(self, now: float, size: float, links: tuple) -> float:
        return self._finish_time(now, size, links)

    def register(self, now: float, size: float, links: tuple) -> float:
        """Start a transfer at ``now``; returns (and freezes) its finish."""
        self._active = [a for a in self._active if a[1] > now]
        fin = self._finish_time(now, size, links)
        if size > 0.0:
            self._active.append((now, fin, tuple(links)))
            if _obs.enabled():
                self.log.append((now, fin, tuple(links), float(size)))
        return fin


# -------------------------------------------- batched contention approximation
@dataclasses.dataclass(frozen=True)
class PlanTransfers:
    """The distinct transfers a plan's allocation implies, in dense arrays.

    One transfer per ``(src task, out_id, destination type)`` crossing —
    output caching: a reused output crosses a given boundary once, not once
    per consumer edge.  ``key_of[e]`` maps each graph edge to its transfer
    (−1 = the edge does not cross).  Links are densely renumbered per plan
    (``link_ids`` preserves the model's hashable link labels) so a batched
    solver can index fixed-size load vectors; every transfer occupies
    exactly two links (``NetworkModel.links_of``: source uplink +
    destination downlink).
    """

    key_of: np.ndarray          # (E,) int64 edge -> transfer id, -1 = no cross
    src: np.ndarray             # (T,) int64 producer task of each transfer
    size: np.ndarray            # (T,) float  data-object size
    up: np.ndarray              # (T,) int64 dense id of the uplink occupied
    dn: np.ndarray              # (T,) int64 dense id of the downlink occupied
    link_ids: tuple             # dense id -> the model's hashable link label
    capacity: float             # the model's link bandwidth

    @property
    def count(self) -> int:
        return len(self.src)

    @property
    def num_links(self) -> int:
        return len(self.link_ids)

    def links(self) -> list[tuple]:
        """Per-transfer link-label tuples (the numpy solvers' format)."""
        return [(self.link_ids[u], self.link_ids[d])
                for u, d in zip(self.up, self.dn)]


def plan_transfers(g: TaskGraph, plan, network: NetworkModel) -> PlanTransfers:
    """Extract the deduplicated transfer set of a plan under a model."""
    E = g.num_edges
    alloc = np.asarray(plan.alloc, dtype=np.int64)
    key_of = np.full(E, -1, dtype=np.int64)
    t_src: list[int] = []
    t_size: list[float] = []
    t_up: list[int] = []
    t_dn: list[int] = []
    link_id: dict = {}
    seen: dict[tuple[int, int, int], int] = {}
    if E:
        sizes = g.data_sizes(network.bandwidth)
        oids = g.edge_out_ids()
        cross = alloc[g.edges[:, 0]] != alloc[g.edges[:, 1]]
        for e in np.flatnonzero(cross):
            src, dst = int(g.edges[e, 0]), int(g.edges[e, 1])
            key = (src, int(oids[e]), int(alloc[dst]))
            if key not in seen:
                seen[key] = len(t_src)
                up, dn = network.links_of(int(alloc[src]), int(alloc[dst]))
                t_src.append(src)
                t_size.append(float(sizes[e]))
                t_up.append(link_id.setdefault(up, len(link_id)))
                t_dn.append(link_id.setdefault(dn, len(link_id)))
            key_of[e] = seen[key]
    return PlanTransfers(key_of=key_of,
                         src=np.asarray(t_src, dtype=np.int64),
                         size=np.asarray(t_size, dtype=np.float64),
                         up=np.asarray(t_up, dtype=np.int64),
                         dn=np.asarray(t_dn, dtype=np.int64),
                         link_ids=tuple(link_id),
                         capacity=float(network.bandwidth))


def _fluid_finishes(starts: np.ndarray, sizes: np.ndarray,
                    links: list[tuple], capacity: float) -> np.ndarray:
    """(T,) exact max-min fluid finish times for transfers with *fixed*
    start times — the decoupled sub-problem ``contended_plan_delays``
    iterates on.  Event-driven: rates are re-solved whenever a transfer
    starts or drains."""
    T = len(starts)
    fin = np.zeros(T)
    remaining = np.asarray(sizes, dtype=np.float64).copy()
    order = sorted(range(T), key=lambda i: starts[i])
    idx, active = 0, []
    t = float(starts[order[0]]) if T else 0.0
    while active or idx < T:
        if not active:
            t = max(t, float(starts[order[idx]]))
        while idx < T and starts[order[idx]] <= t + _EPS:
            i = order[idx]
            idx += 1
            if remaining[i] <= _EPS:
                fin[i] = float(starts[i])     # empty object: instant
            else:
                active.append(i)
        if not active:
            continue
        rates = maxmin_rates([links[i] for i in active], capacity)
        t_done = min(t + remaining[a] / r for a, r in zip(active, rates))
        t_next = float(starts[order[idx]]) if idx < T else np.inf
        t_ev = min(t_done, t_next)
        for a, r in zip(active, rates):
            remaining[a] -= r * (t_ev - t)
        t = t_ev
        done = [a for a in active if remaining[a] <= _EPS * capacity + _EPS]
        for a in done:
            fin[a] = t
            active.remove(a)
    return fin


def contended_plan_delays(g: TaskGraph, plan, times: np.ndarray,
                          network: NetworkModel,
                          release: np.ndarray | None = None,
                          iters: int = 4) -> np.ndarray:
    """(e,) effective per-edge delays approximating a contended replay.

    A noise-free replay of the plan under the current delay vector gives
    each distinct transfer's start (cross edges deduplicated by
    ``(src, out_id, destination type)`` — output caching — start when
    their producer finishes); the decoupled fluid sub-problem — max-min
    fair sharing among transfers with those *fixed* starts — is then
    solved exactly (:func:`_fluid_finishes`) and each edge's delay becomes
    its transfer's fluid duration.  Stretched transfers shift the
    downstream timeline, so the replay/re-solve pair is iterated to a
    fixpoint (``iters`` rounds; 2–3 suffice on the campaign families).
    What the approximation misses relative to the exact engine is only the
    *within-event coupling* of task starts and rate changes.  A lone
    transfer reproduces its fixed-latency delay exactly.  Crucially, the
    whole computation is plain numpy at plan-DAG *build* time: array
    shapes are unchanged, so a batched replay keeps its padded shapes.
    """
    from .engine import _execute_plan   # local: avoid an import cycle

    E = g.num_edges
    if not E:
        return np.zeros(0)
    tr = plan_transfers(g, plan, network)
    if not tr.count:
        return np.zeros(E)
    rel = np.zeros(g.n) if release is None else np.asarray(release, float)
    t_links = tr.links()
    hit = tr.key_of >= 0

    delay = np.zeros(E)
    delay[hit] = tr.size[tr.key_of[hit]] / tr.capacity  # round 0: fixed-latency
    for _ in range(max(1, iters)):
        _, finish = _execute_plan(g, plan, times, rel, delay=delay)
        starts = finish[tr.src]
        fin = _fluid_finishes(starts, tr.size, t_links, tr.capacity)
        new_delay = np.zeros(E)
        new_delay[hit] = (fin - starts)[tr.key_of[hit]]
        if np.allclose(new_delay, delay, rtol=1e-3, atol=1e-9):
            delay = new_delay
            break
        delay = new_delay
    return delay


# ------------------------------------------------ whole-bucket contention
#: fixpoint rounds of the batched contention solve — one value shared by the
#: numpy oracle (``contended_plan_delays(iters=)`` default) and the
#: whole-bucket fixpoint, so the two run the same iteration schedule.
CONTENTION_ITERS = 4

#: The whole-bucket fixpoint is ``"torch"`` (the reference's ``"jax"``: the
#: port runs no JAX); there is no environment switch.
_CONTENTION_KERNELS = ("torch", "numpy")
_contention_kernel = "torch"


def contention_kernel() -> str:
    """Which implementation prices contention on the bucketed batch path:
    ``"torch"`` (the whole-bucket fixpoint, default: the CUDA kernel on the
    card, its plain version on the CPU) or ``"numpy"`` (the per-plan
    reference oracle)."""
    return _contention_kernel


def set_contention_kernel(name: str) -> None:
    global _contention_kernel
    if name not in _CONTENTION_KERNELS:
        raise ValueError(f"unknown contention kernel {name!r}; "
                         f"have {_CONTENTION_KERNELS}")
    _contention_kernel = name


__all__ = [
    "CONTENTION_ITERS", "NETWORKS", "NetworkModel", "InstantNetwork",
    "FixedLatencyNetwork", "MaxMinFairNetwork", "PlanTransfers",
    "TransferTracker", "contended_plan_delays", "contention_kernel",
    "fluid_finishes_ref", "make_network", "maxmin_rates", "plan_transfers",
    "set_contention_kernel",
]
