"""Batched makespan replay of static plans: the port of ``repro.sim.batch``.

The replay of a static ``Plan`` under realized runtimes is a longest-path
computation on the *augmented* DAG = precedence edges + processor-sequence
chain edges (see ``engine._execute_plan``), where a precedence edge whose
endpoints sit on different resource types additionally delays its successor
by the edge's transfer cost ``g.comm[e]`` (chain edges transfer nothing).
That structure is fixed per plan — the allocation decides once and for all
which edges pay — so noise only perturbs the *node* weights, and a whole
batch of (plan, seed) realizations replays in one kernel launch.

Two granularities, as in the reference:

  * ``batch_makespans`` — one plan × (S,) noise realizations.
  * ``BatchedPlanDag`` + ``bucketed_makespans`` — *many different plans*
    (different DAGs, different n, different pred fan-in P) evaluated
    together: plans are grouped into buckets by the power-of-two envelope of
    (n, P), padded to the per-bucket maxima, and each bucket runs as ONE
    launch of the replay kernel (``repro_torch.kernels.replay``) over its
    (plan, seed) lanes on the card, or as its plain version on the CPU.

The host half builds every array in float64 numpy exactly as the reference
does and casts it with ``.to(torch.float32)``: the rounding ``jnp.asarray``
applies with JAX's 64-bit mode off.  The replay is float32 in the
reference's order of operations (max over the unmasked preds of finish +
delay with initial 0, max with the floor, + time), so its makespans equal
the reference's bit for bit, and the float64 ``engine.simulate`` to rtol
1e-5.

``trace_count`` keeps the reference's compile counters: ``bucket`` (and
``single`` for ``batch_makespans``) advance the first time the process
replays a (B, n_pad, P_pad, S) shape, and ``contended`` the first time it
prices a (B, n_pad, P_pad, T_pad, L) shape — what retraces the
reference's jitted evaluators.

Contended networks (``maxmin_fair``) are priced at plan-DAG *build* time:
by default a whole group of plans solves its replay/fluid fixpoint in one
launch of the contention kernel (``contended_bucket_delays`` below, over
``kernels/contention``: ``csrc/contention.cu`` on the card, its plain
float64 version on the CPU); ``set_contention_kernel("numpy")`` routes
through the per-plan numpy oracle instead.  Either way contention enters
``pred_delay`` as numbers, never as new array shapes.  The pipelined
executor (``workers``, ``cache``) and the split of the plan axis over
several cards (``mesh``) come with ROADMAP A4.

Padding scheme: a plan with n tasks and max fan-in P lands in bucket
``(next_pow2(n + 1), next_pow2(P))`` and is padded to that bucket's maxima —
phantom tasks have no predecessors and zero processing time, phantom order
slots point at a phantom task, so they finish at time 0 and never move the
max.  Padded entries of the times matrix are zero-filled by ``_pad_times``.

Release times and busy-machine conditioning enter as per-task start
*floors* (``PlanDag.floor``): a task starts no earlier than its floor, so a
rollout can replay a plan as if the machine's processors only became free
at their current commitment horizons (``rollout_floors``).

Every evaluator takes ``device`` (default ``"cuda"``, through
``repro_torch.resolve_device``, which raises without a card) and returns
numpy arrays, as the reference does; ``build_plan_dag`` and
``BatchedPlanDag.from_plans`` take it for the contention fixpoint, the one
part of a plan's build that runs on the device.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np
import torch

from repro_torch.core.dag import TaskGraph
from repro_torch.device import resolve_device
from repro_torch.kernels.contention import contention as _contention
from repro_torch.kernels.replay import replay as _kernel
from repro_torch.obs import registry as _obs
from repro_torch.platform import as_platform

from .engine import Machine, NoiseModel, Plan, plan_times
from .network import (CONTENTION_ITERS, contended_plan_delays,
                      contention_kernel, plan_transfers)

#: Compile-count kinds of the reference's jitted evaluators, kept under
#: ``sim.compile.<kind>`` in the ``repro_torch.obs`` registry.  Here a kind
#: advances once per new replay shape (see ``_count_shape``).
TRACE_KINDS = ("bucket", "single", "contended")


class _TraceShim:
    """Mapping view over the obs-registry compile counters (the reference's
    legacy ``_TRACES`` interface)."""

    @staticmethod
    def _key(kind: str) -> str:
        if kind not in TRACE_KINDS:
            raise ValueError(f"unknown trace kind {kind!r}; "
                             f"valid kinds: {', '.join(TRACE_KINDS)}")
        return f"sim.compile.{kind}"

    def __getitem__(self, kind: str) -> int:
        return _obs.counter_value(self._key(kind))

    def __setitem__(self, kind: str, value: int) -> None:
        _obs.set_counter(self._key(kind), value)


_TRACES = _TraceShim()

#: Replay shapes each kind has run in this process: the counterpart of the
#: reference's jit cache, which a reset of the counters does not clear.
_SEEN_SHAPES: dict[str, set] = defaultdict(set)


def _count_shape(kind: str, shape: tuple) -> None:
    """Bump ``sim.compile.<kind>`` the first time ``shape`` is replayed."""
    if shape not in _SEEN_SHAPES[kind]:
        _SEEN_SHAPES[kind].add(shape)
        _obs.bump(_TraceShim._key(kind))


def trace_count(kind: str = "bucket") -> int:
    """New replay shapes of the ``kind`` evaluator since process start (or
    the last :func:`reset_trace_counts`) — the reference's XLA trace count.
    Raises ``ValueError`` on unknown kinds, listing the valid ones."""
    return _TRACES[kind]


def reset_trace_counts() -> None:
    """Zero every compile counter — test setup, so assertions read absolute
    counts instead of hand-rolled before/after deltas."""
    for kind in TRACE_KINDS:
        _TRACES[kind] = 0


# ---------------------------------------------------------------- plan DAGs
@dataclasses.dataclass(frozen=True)
class PlanDag:
    """Augmented (precedence + chain) DAG in padded CPU tensors."""

    order: torch.Tensor       # (n,)   int32 topological order (augmented DAG)
    pred: torch.Tensor        # (n, P) int32 padded predecessor ids, -1 = none
    pred_mask: torch.Tensor   # (n, P) bool
    pred_delay: torch.Tensor  # (n, P) float32 transfer delay on that pred edge
    floor: torch.Tensor       # (n,)   float32 per-task earliest-start floor
                              #        (release time / busy-machine
                              #        conditioning); 0 = the classic replay
    width: torch.Tensor       # (n,)   int32 units each task occupies (moldable
                              #        decisions).  The replay does not read
                              #        it — a width-w task's occupancy is its
                              #        w chain preds and its curve-shrunk
                              #        entry in ``times`` — but the plan tensor
                              #        carries the full (type, width) decision.


def _plan_delay_override(g: TaskGraph, plan: Plan, network,
                         device: str | torch.device = "cuda"):
    """Per-edge delay vector a ``NetworkModel`` implies for this plan, or
    ``None`` for the default fixed-latency charging."""
    return _delay_overrides([(g, plan)], [network], device)[0]


def _delay_overrides(items, networks,
                     device: str | torch.device = "cuda") -> list:
    """Per-item per-edge delay vectors (or ``None``) the models imply.

    Non-contended models reduce to closed-form delay arrays.  Contended
    models (``maxmin_fair``) price each plan through the fixed-start
    max-min fluid fixpoint; by default all contended items of the list are
    solved *together* on ``device`` by the whole-bucket fixpoint
    (:func:`contended_bucket_delays` — one launch per padded-shape group),
    while ``set_contention_kernel("numpy")`` routes each through the
    per-plan numpy oracle ``contended_plan_delays`` instead.  Either way
    contention enters the plan DAG as delay *numbers*, never as new array
    shapes.
    """
    if networks is None:
        return [None] * len(items)
    out: list = [None] * len(items)
    contended = []
    for i, ((g, plan), net) in enumerate(zip(items, networks)):
        if net is None:
            continue
        if getattr(net, "contended", False):
            contended.append(i)
        else:
            out[i] = net.plan_delays(g, plan.alloc)
    if contended:
        if contention_kernel() == "numpy":
            for i in contended:
                g, plan = items[i]
                out[i] = contended_plan_delays(
                    g, plan, plan_times(g, plan, g.proc), networks[i])
        else:
            delays = contended_bucket_delays(
                [items[i] for i in contended],
                [networks[i] for i in contended], device=device)
            for i, d in zip(contended, delays):
                out[i] = d
    return out


def _plan_arrays(g: TaskGraph, plan: Plan, delay_e: np.ndarray | None = None):
    """Numpy (order, pred, delay, pred_eid) of the augmented DAG, minimally
    padded.  ``pred_eid[j, k]`` is the graph edge behind pred slot ``(j, k)``
    (−1 on chain/padding slots)."""
    n = g.n
    if delay_e is None:
        delay_e = g.edge_delays(plan.alloc)
    preds: list[list[int]] = [[] for _ in range(n)]
    delays: list[list[float]] = [[] for _ in range(n)]
    eids: list[list[int]] = [[] for _ in range(n)]
    for j in range(n):
        p0, p1 = g.pred_ptr[j], g.pred_ptr[j + 1]
        for i, eid in zip(g.pred_idx[p0:p1], g.pred_eid[p0:p1]):
            preds[j].append(int(i))
            delays[j].append(float(delay_e[eid]))
            eids[j].append(int(eid))
    for seq in plan.sequences.values():
        for a, b in zip(seq[:-1], seq[1:]):
            preds[b].append(a)
            delays[b].append(0.0)
            eids[b].append(-1)

    # Kahn over the augmented graph (it is acyclic by plan feasibility).
    succs: list[list[int]] = [[] for _ in range(n)]
    indeg = np.zeros(n, dtype=np.int64)
    for j, pj in enumerate(preds):
        indeg[j] = len(pj)
        for i in pj:
            succs[i].append(j)
    order = np.empty(n, dtype=np.int32)
    stack = list(np.flatnonzero(indeg == 0))
    head = 0
    while stack:
        u = int(stack.pop())
        order[head] = u
        head += 1
        for v in succs[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                stack.append(v)
    if head != n:
        raise ValueError("augmented plan graph has a cycle (infeasible plan)")

    P = max(1, max((len(p) for p in preds), default=1))
    pred = np.full((n, P), -1, dtype=np.int32)
    delay = np.zeros((n, P), dtype=np.float64)
    pred_eid = np.full((n, P), -1, dtype=np.int64)
    for j, pj in enumerate(preds):
        pred[j, : len(pj)] = pj
        delay[j, : len(pj)] = delays[j]
        pred_eid[j, : len(pj)] = eids[j]
    return order, pred, delay, pred_eid


def _plan_width(g: TaskGraph, plan: Plan) -> np.ndarray:
    """(n,) width column of a plan's decisions (ones on rigid plans)."""
    if plan.width is None:
        return np.ones(g.n, dtype=np.int32)
    return np.asarray(plan.width, dtype=np.int32)


def _f32(a: np.ndarray) -> torch.Tensor:
    """A float64 numpy array rounded to a float32 tensor."""
    return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(torch.float32)


def build_plan_dag(g: TaskGraph, plan: Plan,
                   floor: np.ndarray | None = None,
                   network=None,
                   device: str | torch.device = "cuda") -> PlanDag:
    """Fuse DAG predecessors (with their transfer delays under the plan's
    allocation) with each task's processor-sequence predecessors (one chain
    pred per unit a width-w task occupies).

    ``floor`` optionally gives each task an earliest-start time (release
    times, or per-processor busy horizons — see ``rollout_floors``).
    ``network`` optionally replaces the fixed-latency edge delays with a
    ``NetworkModel``'s (see ``_delay_overrides``), a contended one priced
    on ``device``."""
    order, pred, delay, _ = _plan_arrays(
        g, plan, delay_e=_plan_delay_override(g, plan, network, device))
    f = np.zeros(g.n) if floor is None else np.asarray(floor, dtype=np.float64)
    return PlanDag(order=torch.from_numpy(order), pred=torch.from_numpy(pred),
                   pred_mask=torch.from_numpy(pred >= 0),
                   pred_delay=_f32(delay), floor=_f32(f),
                   width=torch.from_numpy(_plan_width(g, plan)))


def rollout_floors(g: TaskGraph, plan: Plan, busy: list[np.ndarray],
                   now: float = 0.0) -> np.ndarray:
    """(n,) start floors that condition a plan replay on a busy machine.

    ``busy[q]`` holds the commitment horizon of each type-q processor
    (``MachineState.busy_until(q)``); the first task of each per-processor
    sequence inherits the horizon of the processor its plan slot maps to
    (plan pids are matched to machine processors in ascending-horizon order,
    the same greedy order the engine commits in).  Times are relative to
    ``now`` so candidate rollouts at an arrival compare net makespans.
    """
    floor = np.zeros(g.n)
    for (q, pid), seq in plan.sequences.items():
        if seq:
            horizon = busy[q][pid] if pid < len(busy[q]) else 0.0
            floor[seq[0]] = max(0.0, float(horizon) - now)
    return floor




def _replay(order: torch.Tensor, pred: torch.Tensor, delay: torch.Tensor,
            floor: torch.Tensor, times: torch.Tensor, device: torch.device,
            kind: str) -> np.ndarray:
    """(B, S) float32 makespans of one bucket on ``device``: one launch of
    the replay kernel on the card, its plain version on the CPU."""
    _count_shape(kind, (*pred.shape, times.shape[1]))
    args = [t.to(device) for t in (order, pred, delay, floor, times)]
    return _kernel.bucket_makespans(*args).cpu().numpy()


def batch_makespans(g: TaskGraph, plan: Plan, times: np.ndarray,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """Makespan of the plan replayed under each row of ``times`` (S, n)."""
    dev = resolve_device(device)
    times = np.asarray(times, dtype=np.float64)
    if times.ndim != 2 or times.shape[1] != g.n:
        raise ValueError(f"times must be (S, n={g.n}), got {times.shape}")
    dag = build_plan_dag(g, plan)
    return _replay(dag.order[None], dag.pred[None], dag.pred_delay[None],
                   dag.floor[None], _f32(times)[None], dev, "single")[0]


def sample_actual_batch(g: TaskGraph, plan: Plan, noise: NoiseModel,
                        seeds) -> np.ndarray:
    """(S, n) realized times on each task's allocated type, one row per seed.

    Row s uses ``np.random.default_rng(seeds[s])`` exactly like
    ``engine.simulate(..., seed=seeds[s])`` — the two paths see identical
    noise streams.  Moldable decisions shrink each entry by the task's
    speedup curve at the plan's width (``engine.plan_times`` semantics).
    """
    rows = []
    for s in seeds:
        actual = noise.sample(g.proc, np.random.default_rng(int(s)))
        rows.append(plan_times(g, plan, actual))
    return np.stack(rows)


def sweep_makespans(g: TaskGraph, machine: Machine, scheduler, *,
                    noise: NoiseModel, seeds,
                    device: str | torch.device = "cuda") -> np.ndarray:
    """Allocate once, evaluate the whole noise sweep in one launch."""
    dev = resolve_device(device)
    plan = scheduler.allocate(g, machine)
    if plan is None:
        raise ValueError(f"{scheduler.name} is arrival-driven; "
                         "the batch path needs a static plan")
    return batch_makespans(g, plan, sample_actual_batch(g, plan, noise, seeds),
                           device=dev)


# ------------------------------------------------------- bucketed batch path
@dataclasses.dataclass(frozen=True)
class BatchedPlanDag:
    """A bucket of B padded plan-DAGs stacked into CPU tensors."""

    order: torch.Tensor       # (B, n_pad) int32
    pred: torch.Tensor        # (B, n_pad, P_pad) int32, -1 = none
    pred_mask: torch.Tensor   # (B, n_pad, P_pad) bool
    pred_delay: torch.Tensor  # (B, n_pad, P_pad) float32
    floor: torch.Tensor       # (B, n_pad) float32 — per-task start floors
    width: torch.Tensor       # (B, n_pad) int32 — decision widths (phantom
                              #            tasks pad at width 1; see PlanDag)

    @property
    def batch(self) -> int:
        return self.order.shape[0]

    @property
    def n_pad(self) -> int:
        return self.order.shape[1]

    @staticmethod
    def from_plans(items: list[tuple[TaskGraph, Plan]],
                   floors: list[np.ndarray] | None = None,
                   pad_to: tuple[int, int] | None = None,
                   networks: list | None = None,
                   device: str | torch.device = "cuda") -> "BatchedPlanDag":
        """Stack heterogeneous (graph, plan) pairs, padded to shared maxima.

        Items shorter than the bucket get phantom tasks: zero fan-in, zero
        time (``_pad_times``), and the item's spare order slots all point at
        the first phantom, so they finish at 0 and never move the max.  The
        bucket's largest item has no spare slots at all — unless ``pad_to``
        raises the padded shape to a fixed (n_pad, P_pad) envelope, which
        repeated small rollout calls use to replay one stable shape.

        ``floors`` optionally carries per-item (n_i,) start floors (release
        times / busy-machine conditioning); phantom tasks floor at 0.
        ``networks`` optionally carries a per-item ``NetworkModel`` (or
        ``None``) replacing the fixed-latency edge delays — contention
        enters as numbers in ``pred_delay``, never as new array shapes;
        a contended model is priced on ``device``.
        """
        delay_es = _delay_overrides(items, networks, device)
        arrays = [_plan_arrays(g, plan, delay_e=delay_es[i])
                  for i, (g, plan) in enumerate(items)]
        n_pad = max(a[0].shape[0] for a in arrays)
        P_pad = max(a[1].shape[1] for a in arrays)
        if pad_to is not None:
            n_pad, P_pad = max(n_pad, pad_to[0]), max(P_pad, pad_to[1])
        B = len(arrays)
        order = np.zeros((B, n_pad), dtype=np.int32)
        pred = np.full((B, n_pad, P_pad), -1, dtype=np.int32)
        delay = np.zeros((B, n_pad, P_pad), dtype=np.float64)
        floor = np.zeros((B, n_pad), dtype=np.float64)
        width = np.ones((B, n_pad), dtype=np.int32)
        for b, (o, p, d, _) in enumerate(arrays):
            n, Pi = p.shape
            order[b, :n] = o
            order[b, n:] = n  # empty slice for the bucket's largest item
            pred[b, :n, :Pi] = p
            delay[b, :n, :Pi] = d
            width[b, :n] = _plan_width(items[b][0], items[b][1])
            if floors is not None:
                floor[b, :n] = floors[b]
        return BatchedPlanDag(order=torch.from_numpy(order),
                              pred=torch.from_numpy(pred),
                              pred_mask=torch.from_numpy(pred >= 0),
                              pred_delay=_f32(delay), floor=_f32(floor),
                              width=torch.from_numpy(width))


def _pad_times(times: np.ndarray, n_pad: int) -> np.ndarray:
    """(S, n) -> (S, n_pad), phantom tasks take zero time."""
    S, n = times.shape
    if n == n_pad:
        return times
    out = np.zeros((S, n_pad), dtype=times.dtype)
    out[:, :n] = times
    return out


def _bucket_key(g: TaskGraph, plan: Plan) -> tuple[int, int]:
    """Power-of-two envelope of (n + 1 phantom slot, max augmented fan-in).

    The augmented fan-in is bounded by the DAG fan-in plus one chain pred
    per unit of the widest decision (1 on rigid plans); using the bound
    (instead of the exact value) keeps the key cheap and stable.
    """
    n = g.n
    fan = int(np.diff(g.pred_ptr).max()) if g.n else 0
    p = fan + (int(plan.width.max()) if plan.width is not None else 1)
    return (1 << int(np.ceil(np.log2(max(n + 1, 2)))),
            1 << int(np.ceil(np.log2(max(p, 1)))))


def bucket_plans(items: list[tuple[TaskGraph, Plan]]
                 ) -> dict[tuple[int, int], list[int]]:
    """Group item indices by padded-shape bucket."""
    buckets: dict[tuple[int, int], list[int]] = defaultdict(list)
    for i, (g, plan) in enumerate(items):
        buckets[_bucket_key(g, plan)].append(i)
    return dict(buckets)


def bucket_times(times: list[np.ndarray], n_pad: int) -> torch.Tensor:
    """(B, S, n_pad) float32 times of a bucket, phantom tasks at zero."""
    return _f32(np.stack([_pad_times(np.asarray(t, dtype=np.float64), n_pad)
                          for t in times]))


def _bucket_makespans(bd: BatchedPlanDag, times: torch.Tensor,
                      device: torch.device) -> np.ndarray:
    """(B, S) makespans of one bucket: the kernel on the card."""
    return _replay(bd.order, bd.pred, bd.pred_delay, bd.floor, times, device,
                   "bucket")


def _pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(int(x), 1)))))


# -------------------------------------------------- contended bucket kernel
@dataclasses.dataclass(frozen=True)
class ContendedBucket:
    """A group of B padded plans plus their transfer sets, stacked into CPU
    tensors for the whole-bucket contention fixpoint
    (``_contended_durations``)."""

    order: torch.Tensor      # (B, n_pad) int32 topological order
    pred: torch.Tensor       # (B, n_pad, P_pad) int32, -1 = none
    pred_mask: torch.Tensor  # (B, n_pad, P_pad) bool
    pred_tid: torch.Tensor   # (B, n_pad, P_pad) int32 transfer behind each
                             #      pred slot, -1 = chain/non-cross/padding
    times: torch.Tensor      # (B, n_pad) float64 nominal (noise-free) times
    src: torch.Tensor        # (B, T_pad) int32 producer task per transfer
    size: torch.Tensor       # (B, T_pad) float64 data-object sizes
    up: torch.Tensor         # (B, T_pad) int32 dense uplink ids
    dn: torch.Tensor         # (B, T_pad) int32 dense downlink ids
    t_mask: torch.Tensor     # (B, T_pad) bool real-transfer lanes
    capacity: torch.Tensor   # (B,) float64 link bandwidth per plan

    def tensors(self) -> tuple[torch.Tensor, ...]:
        """The fields in the order the contention kernel takes them."""
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self))


def _contended_durations(cb: ContendedBucket, num_links: int, iters: int,
                         device: torch.device) -> np.ndarray:
    """(B, T_pad) float64 fluid transfer durations at the replay/fluid
    fixpoint, on ``device``: one launch of the contention kernel for a
    CUDA device, its plain version on the CPU.  The first solve of each
    (B, n_pad, P_pad, T_pad, L) shape bumps ``trace_count("contended")``."""
    B, n_pad, P_pad = cb.pred.shape
    _count_shape("contended", (B, n_pad, P_pad, cb.size.shape[1], num_links))
    args = [t.to(device) for t in cb.tensors()]
    return _contention.contended_durations(
        *args, num_links=num_links, iters=iters).cpu().numpy()


def contended_buckets(items: list, networks: list):
    """Group the contended items as :func:`contended_bucket_delays` solves
    them.  Returns ``(zeros, groups)``: ``zeros`` maps each item with no
    crossing transfer to its (E,) zero delays; ``groups`` maps each
    ``(n_pad, P_pad, L)`` to ``(idxs, transfers, bucket)``, the group's
    item indices, their ``PlanTransfers`` and its ``ContendedBucket``."""
    zeros: dict[int, np.ndarray] = {}
    members: dict[tuple, list[int]] = defaultdict(list)
    prep: dict[int, tuple] = {}
    for i, ((g, plan), net) in enumerate(zip(items, networks)):
        tr = plan_transfers(g, plan, net)
        if not tr.count:
            zeros[i] = np.zeros(g.num_edges)
            continue
        arrays = _plan_arrays(g, plan, delay_e=np.zeros(g.num_edges))
        prep[i] = (tr, arrays, plan_times(g, plan, g.proc))
        n_pad, P_pad = _bucket_key(g, plan)
        members[(n_pad, P_pad, tr.num_links)].append(i)

    groups = {}
    for (n_pad, P_pad, L), idxs in members.items():
        B = len(idxs)
        T_pad = _pow2(max(prep[i][0].count for i in idxs))
        order = np.zeros((B, n_pad), dtype=np.int32)
        pred = np.full((B, n_pad, P_pad), -1, dtype=np.int32)
        tid = np.full((B, n_pad, P_pad), -1, dtype=np.int32)
        times = np.zeros((B, n_pad), dtype=np.float64)
        src = np.zeros((B, T_pad), dtype=np.int32)
        size = np.zeros((B, T_pad), dtype=np.float64)
        up = np.zeros((B, T_pad), dtype=np.int32)
        dn = np.zeros((B, T_pad), dtype=np.int32)
        t_mask = np.zeros((B, T_pad), dtype=bool)
        cap = np.zeros(B, dtype=np.float64)
        for b, i in enumerate(idxs):
            tr, (o, p, _, pe), base = prep[i]
            n, Pi = p.shape
            order[b, :n] = o
            order[b, n:] = n  # spare slots visit the first phantom task
            pred[b, :n, :Pi] = p
            m = pe >= 0
            ti = np.full((n, Pi), -1, dtype=np.int32)
            ti[m] = tr.key_of[pe[m]]
            tid[b, :n, :Pi] = ti
            times[b, :n] = base
            T = tr.count
            src[b, :T] = tr.src
            size[b, :T] = tr.size
            up[b, :T] = tr.up
            dn[b, :T] = tr.dn
            t_mask[b, :T] = True
            cap[b] = tr.capacity
        cb = ContendedBucket(
            order=torch.from_numpy(order), pred=torch.from_numpy(pred),
            pred_mask=torch.from_numpy(pred >= 0),
            pred_tid=torch.from_numpy(tid), times=torch.from_numpy(times),
            src=torch.from_numpy(src), size=torch.from_numpy(size),
            up=torch.from_numpy(up), dn=torch.from_numpy(dn),
            t_mask=torch.from_numpy(t_mask), capacity=torch.from_numpy(cap))
        groups[(n_pad, P_pad, L)] = (idxs, [prep[i][0] for i in idxs], cb)
    return zeros, groups


def contended_bucket_delays(items: list, networks: list,
                            device: str | torch.device = "cuda"
                            ) -> list[np.ndarray]:
    """Per-item (E_i,) per-edge delay vectors from the whole-bucket
    contention fixpoint — the batched front door ``_delay_overrides`` calls.

    Items are grouped by ``(bucket_key, num_links)`` — the same
    power-of-two (n, fan-in) envelope the makespan path buckets by — and
    each group's transfer axis is padded to the power-of-two envelope of
    its largest transfer set (``contended_buckets``), so a campaign's
    contended grid costs one launch of the contention kernel per group on
    the card; plans with no crossing transfers short-circuit to zeros.  The
    fixpoint is float64, like the reference's under x64, and matches the
    float64 numpy oracle to rtol 1e-6; the resulting durations scatter back
    to the (deduplicated, output-cached) edges via ``PlanTransfers.key_of``.
    """
    dev = resolve_device(device)
    zeros, groups = contended_buckets(items, networks)
    out: list[np.ndarray | None] = [None] * len(items)
    for i, z in zeros.items():
        out[i] = z
    for (n_pad, P_pad, L), (idxs, transfers, cb) in groups.items():
        with _obs.span("sim.contended.fixpoint", bucket=f"{n_pad}x{P_pad}",
                       links=L, plans=len(idxs)):
            durs = _contended_durations(cb, L, CONTENTION_ITERS, dev)
        for b, (i, tr) in enumerate(zip(idxs, transfers)):
            delay = np.zeros(items[i][0].num_edges)
            hit = tr.key_of >= 0
            delay[hit] = durs[b, tr.key_of[hit]]
            out[i] = delay
    return out  # type: ignore[return-value]


def _check_grid(items, times) -> None:
    """The reference's argument checks shared by both bucketed entries."""
    S = {t.shape[0] for t in times}
    if len(S) != 1:
        raise ValueError(
            f"all items must share one seed grid, got S={sorted(S)}")
    for (g, _), t in zip(items, times):
        if t.ndim != 2 or t.shape[1] != g.n:
            raise ValueError(f"times must be (S, n={g.n}), got {t.shape}")


def bucketed_makespans(items: list[tuple[TaskGraph, Plan]],
                       times: list[np.ndarray],
                       floors: list[np.ndarray] | None = None,
                       envelope: bool = False,
                       networks: list | None = None,
                       device: str | torch.device = "cuda"
                       ) -> list[np.ndarray]:
    """Replay many different plans under per-plan times matrices.

    Args:
      items: (graph, plan) pairs — arbitrary mixed sizes.
      times: matching (S, n_i) realized-time matrices; S must agree across
             items (one campaign = one seed grid).
      floors: optional matching (n_i,) per-task start floors (release times
             or busy-machine conditioning, see ``rollout_floors``).
      envelope: pad every bucket to its full power-of-two (n, fan-in)
             envelope instead of the per-call maxima, so *repeated* calls
             with same-bucket items (the simulation-in-the-loop rollout
             pattern) replay one stable shape.
      networks: optional matching per-item ``NetworkModel`` (or ``None``)
             entries — edge delays are replaced at plan-DAG build time.
      device: where the replay runs: ``"cuda"`` (the kernel) or ``"cpu"``
             (its plain version).

    Returns a list of (S,) float32 makespan arrays, one per item, in input
    order.  Cost: one kernel launch per *bucket* (power-of-two envelope of
    (n, fan-in)), not per item.
    """
    dev = resolve_device(device)
    if len(items) != len(times):
        raise ValueError("items and times must align")
    if floors is not None and len(floors) != len(items):
        raise ValueError("floors and items must align")
    if networks is not None and len(networks) != len(items):
        raise ValueError("networks and items must align")
    if not items:
        return []
    _check_grid(items, times)

    out: list[np.ndarray | None] = [None] * len(items)
    for key, idxs in bucket_plans(items).items():
        with _obs.span("sim.bucket.build", bucket=f"{key[0]}x{key[1]}",
                       plans=len(idxs)):
            bd = BatchedPlanDag.from_plans(
                [items[i] for i in idxs],
                floors=([floors[i] for i in idxs]
                        if floors is not None else None),
                pad_to=key if envelope else None,
                networks=([networks[i] for i in idxs]
                          if networks is not None else None),
                device=dev)
            tt = bucket_times([times[i] for i in idxs], bd.n_pad)
        with _obs.span("sim.bucket.execute", bucket=f"{key[0]}x{key[1]}",
                       plans=len(idxs)):
            ms = _bucket_makespans(bd, tt, dev)
        for row, i in enumerate(idxs):
            out[i] = ms[row]
    return out  # type: ignore[return-value]


def fixed_envelope_makespans(items: list[tuple[TaskGraph, Plan]],
                             times: list[np.ndarray],
                             pad_to: tuple[int, int],
                             floors: list[np.ndarray] | None = None,
                             device: str | torch.device = "cuda"
                             ) -> list[np.ndarray]:
    """Replay many plans as ONE bucket padded to a caller-fixed envelope.

    :func:`bucketed_makespans` keys each plan by its own power-of-two
    envelope, so a population whose widths straddle a power-of-two boundary
    splits into several buckets whose composition shifts call to call.
    Iterative searches instead pin BOTH axes: every call pads all plans to
    the same ``pad_to = (n_pad, P_pad)`` envelope and the caller keeps
    ``len(items)`` constant, so a whole generation loop replays one shape.

    Every item must FIT the envelope — a plan larger than ``pad_to`` would
    silently grow the shape, so it raises instead.

    Returns a list of (S,) makespan arrays, one per item, in input order.
    """
    dev = resolve_device(device)
    if len(items) != len(times):
        raise ValueError("items and times must align")
    if not items:
        return []
    _check_grid(items, times)
    with _obs.span("sim.bucket.build", bucket=f"{pad_to[0]}x{pad_to[1]}",
                   plans=len(items)):
        bd = BatchedPlanDag.from_plans(items, floors=floors, pad_to=pad_to,
                                       device=dev)
        if (bd.n_pad, bd.pred.shape[2]) != tuple(pad_to):
            raise ValueError(
                f"item exceeds the fixed envelope {tuple(pad_to)}: bucket "
                f"padded to {(bd.n_pad, bd.pred.shape[2])}")
        tt = bucket_times(times, bd.n_pad)
    with _obs.span("sim.bucket.execute", bucket=f"{pad_to[0]}x{pad_to[1]}",
                   plans=len(items)):
        ms = _bucket_makespans(bd, tt, dev)
    return [ms[i] for i in range(len(items))]


def search_envelope(g: TaskGraph, machine) -> tuple[int, int]:
    """The fixed power-of-two envelope covering EVERY legal plan of
    ``(g, machine)`` — what :func:`fixed_envelope_makespans` pads to so a
    whole search (any allocation, any legal widths) shares one shape.
    Matches :func:`_bucket_key` at the graph's maximum legal width."""
    counts = as_platform(machine, warn=False).to_counts()
    n = g.n
    fan = int(np.diff(g.pred_ptr).max()) if g.n else 0
    wcap = max(1, min(int(g.max_width), max(counts)))
    return (_pow2(n + 1), _pow2(fan + wcap))


def sweep_suite_makespans(entries, *, noise: NoiseModel, seeds,
                          floor_fn=None, envelope: bool = False,
                          network=None, workers: int = 1,
                          cache: bool = False,
                          device: str | torch.device = "cuda"
                          ) -> list[np.ndarray]:
    """One-launch-per-bucket campaign sweep over heterogeneous (g, machine,
    scheduler) entries: allocate each plan once, sample its noise grid with
    the engine-identical streams, and evaluate every (entry × seed) makespan
    through the bucketed path.

    ``floor_fn(g, plan) -> (n,)`` optionally conditions each replay on
    per-task start floors (busy machine / release times); ``envelope=True``
    pads to the full bucket envelope so repeated small sweeps replay one
    shape per bucket.  ``network`` applies one ``NetworkModel`` to every
    entry's replay.

    This is the reference's serial route.  Its pipelined executor
    (``workers != 1``, ``cache=True``) is not ported yet (ROADMAP A4), and
    asking for it raises ``NotImplementedError`` rather than running
    serially.

    Returns a list of (S,) arrays aligned with ``entries``.
    """
    if workers is None or workers != 1 or cache:
        raise NotImplementedError(
            "the pipelined sweep (workers != 1 or cache=True) is not ported "
            "yet: ROADMAP A4")
    dev = resolve_device(device)
    items, rows, floors = [], [], []
    for g, machine, scheduler in entries:
        plan = scheduler.allocate(g, machine)
        if plan is None:
            raise ValueError(f"{scheduler.name} is arrival-driven; "
                             "the batch path needs a static plan")
        items.append((g, plan))
        rows.append(sample_actual_batch(g, plan, noise, seeds))
        if floor_fn is not None:
            floors.append(np.asarray(floor_fn(g, plan), dtype=np.float64))
    return bucketed_makespans(items, rows,
                              floors=floors if floor_fn is not None else None,
                              envelope=envelope,
                              networks=([network] * len(items)
                                        if network is not None else None),
                              device=dev)
