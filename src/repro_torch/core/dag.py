"""Precedence task graphs for heterogeneous scheduling.

The paper's object of study: a DAG G=(V,E) of sequential tasks, where task j
takes ``proc[j, q]`` time units on a processor of type q.  For the hybrid
(CPU, GPU) case Q=2 with the convention q=0 -> CPU (p-bar), q=1 -> GPU
(p-underbar), matching the paper's notation.

Beyond the paper's zero-cost machine model, every edge optionally carries a
*transfer cost* ``comm[e]`` (default zero): when the two endpoints run on
different resource types, the successor's data is ready only ``comm[e]``
time units after the predecessor finishes.  This is the per-edge network
model of ESTEE-style simulators and the StarPU/Chameleon substrate the
paper actually ran on; with ``comm == 0`` every algorithm below reduces
bit-for-bit to the paper's communication-free semantics.

Tasks may additionally be *moldable* (Prou et al., Beaumont et al.): an
optional per-task speedup curve ``speedup[j, w-1]`` gives the factor by
which task j shrinks when it occupies ``w`` units of one pool, so the
processing time of a ``(type, width)`` decision (``repro_torch.platform.Decision``)
is ``proc_w(j, q, w) = proc[j, q] / speedup[j, w-1]``.  ``proc[j, q]`` is
exactly the width-1 point of that surface (``speedup[:, 0] == 1`` is
enforced), and a graph without curves (``speedup is None``) is the paper's
rigid width-1 model bit-for-bit.  Curves must be non-decreasing in width
with non-increasing per-unit efficiency ``speedup[w]/w`` (work never
shrinks) — see :func:`amdahl_speedup` / :func:`powerlaw_speedup`.

The representation is fully vectorized (CSR adjacency + topological levels) so
that critical-path / rank computations run as numpy sweeps (and, in
``repro_torch.core.hlp_jax``, as level-scans on the card).  The CSR arrays carry the
originating edge index (``pred_eid`` / ``succ_eid``) so per-edge costs are
addressable from either endpoint without searching.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

CPU, GPU = 0, 1  # resource-type indices for the hybrid (Q=2) case


# ------------------------------------------------------------ speedup curves
def validate_speedup(speedup: np.ndarray, n: int) -> np.ndarray:
    """Check a (n, W) moldable speedup table's invariants.

    * ``speedup[:, 0] == 1`` — ``proc[j, q]`` is the width-1 point;
    * non-decreasing in width — more units never slow a task;
    * per-unit efficiency ``speedup[:, w-1] / w`` non-increasing — total
      work ``w * p/speedup`` never shrinks when widening (no super-linear
      speedups; the area bound in the moldable LP relies on it).
    """
    s = np.asarray(speedup, dtype=np.float64)
    if s.ndim != 2 or s.shape[0] != n:
        raise ValueError(f"speedup must be (n={n}, W), got {s.shape}")
    if not np.allclose(s[:, 0], 1.0, atol=1e-12):
        raise ValueError("speedup[:, 0] must be 1 (proc is the width-1 point)")
    if s.shape[1] > 1:
        if (np.diff(s, axis=1) < -1e-12).any():
            raise ValueError("speedup must be non-decreasing in width")
        eff = s / np.arange(1, s.shape[1] + 1)
        if (np.diff(eff, axis=1) > 1e-12).any():
            raise ValueError("per-unit efficiency speedup[w]/w must be "
                             "non-increasing in width")
    return s


def amdahl_speedup(alpha, max_width: int) -> np.ndarray:
    """Amdahl-law curve table: speedup(w) = 1 / ((1-α) + α/w).

    ``alpha`` is the parallel fraction — scalar or (n,); returns (n, W)
    (or (1, W) for a scalar), vectorized over tasks and widths.
    """
    a = np.atleast_1d(np.asarray(alpha, dtype=np.float64))[:, None]
    if (a < 0).any() or (a > 1).any():
        raise ValueError("Amdahl parallel fraction must be in [0, 1]")
    w = np.arange(1, max_width + 1, dtype=np.float64)[None, :]
    return 1.0 / ((1.0 - a) + a / w)


def powerlaw_speedup(gamma, max_width: int) -> np.ndarray:
    """Power-law curve table: speedup(w) = w**γ, γ ∈ [0, 1] (the Prou et al.
    malleable-task model).  Scalar or (n,) γ; returns (n, W)."""
    g = np.atleast_1d(np.asarray(gamma, dtype=np.float64))[:, None]
    if (g < 0).any() or (g > 1).any():
        raise ValueError("power-law exponent must be in [0, 1]")
    w = np.arange(1, max_width + 1, dtype=np.float64)[None, :]
    return w ** g


@dataclasses.dataclass(frozen=True)
class TaskGraph:
    """Immutable DAG with per-type processing times and per-edge transfer costs.

    Attributes:
      proc:    (n, Q) float64 — processing time of task j on resource type q.
      edges:   (e, 2) int32   — (pred, succ) pairs.
      comm:    (e,) float64   — transfer cost of each edge, charged when the
                                endpoints are placed on *different* types.
      pred_ptr/pred_idx: CSR of predecessors.
      pred_eid: edge index (row of ``edges``/``comm``) aligned with pred_idx.
      succ_ptr/succ_idx: CSR of successors.
      succ_eid: edge index aligned with succ_idx.
      topo:    (n,) int32     — a topological order.
      level:   (n,) int32     — topological level (longest #edges from a source).
      names:   optional task names (kernel class etc.).
      size:    optional (e,) float64 — bytes of the *data object* each edge
               ships (first-class data: what contended network models
               meter).  ``None`` defaults every edge to ``comm × bandwidth``
               so the two parameterizations describe the same traffic.
      out_id:  optional (e,) int64 — id of the produced output each edge
               ships.  Edges sharing an ``out_id`` reuse one object, so a
               contended model sends it across a given type boundary once
               (output caching).  ``None`` = every edge its own object.
    """

    proc: np.ndarray
    edges: np.ndarray
    comm: np.ndarray
    pred_ptr: np.ndarray
    pred_idx: np.ndarray
    pred_eid: np.ndarray
    succ_ptr: np.ndarray
    succ_idx: np.ndarray
    succ_eid: np.ndarray
    topo: np.ndarray
    level: np.ndarray
    names: tuple[str, ...] | None = None
    speedup: np.ndarray | None = None   # (n, W) moldable curve table
    size: np.ndarray | None = None      # (e,) data-object bytes per edge
    out_id: np.ndarray | None = None    # (e,) producing-output id per edge

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(proc: np.ndarray, edges: Iterable[tuple[int, int]],
              names: Sequence[str] | None = None,
              comm: np.ndarray | None = None,
              speedup: np.ndarray | None = None,
              size: np.ndarray | None = None,
              out_id: np.ndarray | None = None) -> "TaskGraph":
        proc = np.asarray(proc, dtype=np.float64)
        if proc.ndim != 2:
            raise ValueError(f"proc must be (n, Q), got {proc.shape}")
        n = proc.shape[0]
        e = np.asarray(list(edges), dtype=np.int32).reshape(-1, 2)
        if e.size and (e.min() < 0 or e.max() >= n):
            raise ValueError("edge endpoint out of range")
        if e.size and np.any(e[:, 0] == e[:, 1]):
            raise ValueError("self-loop")
        if comm is None:
            comm = np.zeros(e.shape[0], dtype=np.float64)
        else:
            comm = np.asarray(comm, dtype=np.float64)
            if comm.shape != (e.shape[0],):
                raise ValueError(f"comm must be ({e.shape[0]},), got {comm.shape}")
            if (comm < 0).any():
                raise ValueError("negative transfer cost")
        if size is not None:
            size = np.asarray(size, dtype=np.float64)
            if size.shape != (e.shape[0],):
                raise ValueError(f"size must be ({e.shape[0]},), got {size.shape}")
            if (size < 0).any():
                raise ValueError("negative data-object size")
        if out_id is not None:
            out_id = np.asarray(out_id, dtype=np.int64)
            if out_id.shape != (e.shape[0],):
                raise ValueError(f"out_id must be ({e.shape[0]},), "
                                 f"got {out_id.shape}")

        def csr(targets: np.ndarray, keys: np.ndarray):
            order = np.argsort(keys, kind="stable")
            idx = targets[order].astype(np.int32)
            eid = order.astype(np.int32)
            ptr = np.zeros(n + 1, dtype=np.int64)
            np.add.at(ptr, keys + 1, 1)
            np.cumsum(ptr, out=ptr)
            return ptr, idx, eid

        if e.size:
            pred_ptr, pred_idx, pred_eid = csr(e[:, 0], e[:, 1])  # preds of j
            succ_ptr, succ_idx, succ_eid = csr(e[:, 1], e[:, 0])  # succs of i
        else:
            pred_ptr = np.zeros(n + 1, dtype=np.int64); pred_idx = np.zeros(0, np.int32)
            succ_ptr = np.zeros(n + 1, dtype=np.int64); succ_idx = np.zeros(0, np.int32)
            pred_eid = np.zeros(0, np.int32); succ_eid = np.zeros(0, np.int32)

        # Kahn topological sort + level computation.
        indeg = np.diff(pred_ptr).astype(np.int64)
        level = np.zeros(n, dtype=np.int32)
        topo = np.empty(n, dtype=np.int32)
        head = 0
        frontier = np.flatnonzero(indeg == 0).astype(np.int32)
        topo[:frontier.size] = frontier
        head = frontier.size
        read = 0
        indeg_work = indeg.copy()
        while read < head:
            u = topo[read]; read += 1
            for v in succ_idx[succ_ptr[u]:succ_ptr[u + 1]]:
                indeg_work[v] -= 1
                if level[v] < level[u] + 1:
                    level[v] = level[u] + 1
                if indeg_work[v] == 0:
                    topo[head] = v; head += 1
        if head != n:
            raise ValueError("graph has a cycle")
        if speedup is not None:
            speedup = validate_speedup(speedup, n)
        return TaskGraph(proc=proc, edges=e, comm=comm,
                         pred_ptr=pred_ptr, pred_idx=pred_idx, pred_eid=pred_eid,
                         succ_ptr=succ_ptr, succ_idx=succ_idx, succ_eid=succ_eid,
                         topo=topo, level=level,
                         names=tuple(names) if names is not None else None,
                         speedup=speedup, size=size, out_id=out_id)

    # ------------------------------------------------------------- properties
    @property
    def n(self) -> int:
        return self.proc.shape[0]

    @property
    def num_types(self) -> int:
        return self.proc.shape[1]

    @property
    def num_edges(self) -> int:
        return self.edges.shape[0]

    @property
    def has_comm(self) -> bool:
        """True when any edge carries a nonzero transfer cost."""
        return bool(self.comm.size) and bool(self.comm.any())

    @property
    def max_width(self) -> int:
        """Largest usable task width (1 when the graph carries no curves)."""
        return 1 if self.speedup is None else int(self.speedup.shape[1])

    def preds(self, j: int) -> np.ndarray:
        return self.pred_idx[self.pred_ptr[j]:self.pred_ptr[j + 1]]

    def succs(self, j: int) -> np.ndarray:
        return self.succ_idx[self.succ_ptr[j]:self.succ_ptr[j + 1]]

    def pred_edges(self, j: int) -> np.ndarray:
        """Edge indices (rows of ``edges``/``comm``) of j's incoming edges."""
        return self.pred_eid[self.pred_ptr[j]:self.pred_ptr[j + 1]]

    def succ_edges(self, j: int) -> np.ndarray:
        """Edge indices of j's outgoing edges, aligned with ``succs(j)``."""
        return self.succ_eid[self.succ_ptr[j]:self.succ_ptr[j + 1]]

    def with_comm(self, comm: np.ndarray | float) -> "TaskGraph":
        """Copy of this graph with new per-edge transfer costs.

        Explicit data-object sizes are dropped (reset to the
        ``comm × bandwidth`` default): they were consistent with the *old*
        costs, and keeping them would silently desynchronize the fixed-
        latency and contended views of the same traffic."""
        c = np.broadcast_to(np.asarray(comm, dtype=np.float64),
                            (self.num_edges,)).copy()
        if (c < 0).any():
            raise ValueError("negative transfer cost")
        return dataclasses.replace(self, comm=c, size=None)

    def data_sizes(self, bandwidth: float = 1.0) -> np.ndarray:
        """(e,) bytes of each edge's data object — the explicit ``size``
        column when present, else the ``comm × bandwidth`` default under
        which a lone transfer takes exactly its fixed-latency time."""
        if self.size is not None:
            return self.size
        return self.comm * float(bandwidth)

    def edge_out_ids(self) -> np.ndarray:
        """(e,) producing-output id of each edge (``out_id`` when present,
        else each edge ships its own object)."""
        if self.out_id is not None:
            return self.out_id
        return np.arange(self.num_edges, dtype=np.int64)

    def with_speedup(self, speedup: np.ndarray) -> "TaskGraph":
        """Copy of this graph with a (n, W) moldable speedup table attached
        (validated; a (W,) or single-row (1, W) curve — e.g. a scalar-α
        :func:`amdahl_speedup` — broadcasts to every task)."""
        s = np.asarray(speedup, dtype=np.float64)
        if s.ndim == 1:
            s = s[None, :]
        if s.ndim == 2 and s.shape[0] == 1 and self.n != 1:
            s = np.broadcast_to(s, (self.n, s.shape[1])).copy()
        return dataclasses.replace(self, speedup=validate_speedup(s, self.n))

    # ------------------------------------------------------------ graph algos
    def alloc_times(self, alloc: np.ndarray) -> np.ndarray:
        """Processing time of each task under an integral allocation (n,)->type."""
        return self.proc[np.arange(self.n), np.asarray(alloc, dtype=np.int64)]

    def proc_w(self, j: int, q: int, w: int) -> float:
        """Processing time of task j on ``w`` units of type ``q`` —
        ``proc[j, q]`` is the width-1 point of this surface."""
        if w == 1 or self.speedup is None:
            return float(self.proc[j, q])
        return float(self.proc[j, q] / self.speedup[j, w - 1])

    def moldable_times(self, alloc: np.ndarray,
                       width: np.ndarray | None = None) -> np.ndarray:
        """(n,) processing times under per-task ``(type, width)`` decisions.

        ``width=None`` (or an all-ones vector on a curve-free graph) is
        exactly :meth:`alloc_times` — the paper's rigid model.
        """
        t = self.alloc_times(alloc)
        if width is None or self.speedup is None:
            return t
        w = np.asarray(width, dtype=np.int64)
        if w.shape != (self.n,):
            raise ValueError(f"width must be (n,), got {w.shape}")
        if (w < 1).any() or (w > self.max_width).any():
            raise ValueError("width out of range of the speedup table")
        return t / self.speedup[np.arange(self.n), w - 1]

    def frac_times(self, x: np.ndarray) -> np.ndarray:
        """Hybrid fractional length p̄_j x_j + p_j (1 - x_j) (paper's HLP)."""
        assert self.num_types == 2
        return self.proc[:, CPU] * x + self.proc[:, GPU] * (1.0 - x)

    def edge_delays(self, alloc: np.ndarray) -> np.ndarray:
        """(e,) effective transfer delay of each edge under an allocation:
        ``comm[e]`` where the endpoints sit on different types, else 0."""
        if not self.num_edges:
            return np.zeros(0)
        a = np.asarray(alloc, dtype=np.int64)
        cross = a[self.edges[:, 0]] != a[self.edges[:, 1]]
        return np.where(cross, self.comm, 0.0)

    def critical_path(self, times: np.ndarray,
                      edge_delay: np.ndarray | None = None) -> float:
        """Longest path weight (task lengths ``times``, optional per-edge
        delays) — forward sweep in topo order."""
        finish = np.zeros(self.n)
        for u in self.topo:
            start = 0.0
            p0, p1 = self.pred_ptr[u], self.pred_ptr[u + 1]
            if p1 > p0:
                pf = finish[self.pred_idx[p0:p1]]
                if edge_delay is not None:
                    pf = pf + edge_delay[self.pred_eid[p0:p1]]
                start = pf.max()
            finish[u] = start + times[u]
        return float(finish.max()) if self.n else 0.0

    def upward_rank(self, times: np.ndarray,
                    edge_delay: np.ndarray | None = None) -> np.ndarray:
        """rank(T_j) = times[j] + max_{i in succ(j)} (delay_ji + rank(T_i))
        (paper §4.1 / HEFT; delays default to zero = the paper's model)."""
        rank = np.zeros(self.n)
        for u in self.topo[::-1]:
            s0, s1 = self.succ_ptr[u], self.succ_ptr[u + 1]
            if s1 > s0:
                sr = rank[self.succ_idx[s0:s1]]
                if edge_delay is not None:
                    sr = sr + edge_delay[self.succ_eid[s0:s1]]
                best = sr.max()
            else:
                best = 0.0
            rank[u] = times[u] + best
        return rank

    def earliest_ready(self, times: np.ndarray,
                       edge_delay: np.ndarray | None = None) -> np.ndarray:
        """Per-task earliest start ignoring resource limits (downward pass)."""
        est = np.zeros(self.n)
        for u in self.topo:
            p0, p1 = self.pred_ptr[u], self.pred_ptr[u + 1]
            if p1 > p0:
                pi = self.pred_idx[p0:p1]
                fin = est[pi] + times[pi]
                if edge_delay is not None:
                    fin = fin + edge_delay[self.pred_eid[p0:p1]]
                est[u] = fin.max()
        return est

    # ---------------------------------------------------------------- helpers
    def graham_lower_bound(self, counts: Sequence[int], alloc: np.ndarray,
                           width: np.ndarray | None = None) -> float:
        """max(CP, load_q / m_q) — the lower bound HLP optimizes, for integral
        (type, width) decisions.  The CP term charges cross-type transfer
        delays (zero under the paper's model); a width-w task contributes
        ``w ×`` its (curve-shrunk) time to its pool's load — the area it
        actually occupies."""
        t = self.moldable_times(alloc, width)
        cp = self.critical_path(t, self.edge_delays(alloc) if self.has_comm
                                else None)
        area = t if width is None else t * np.asarray(width, dtype=np.float64)
        loads = [area[alloc == q].sum() / counts[q]
                 for q in range(self.num_types)]
        return max([cp] + loads)

    def lp_objective(self, counts: Sequence[int], x: np.ndarray) -> float:
        """Exact λ(x) for a *fractional* hybrid allocation x (CPU share)."""
        assert self.num_types == 2
        t = self.frac_times(x)
        cp = self.critical_path(t)
        load_c = float(self.proc[:, CPU] @ x) / counts[CPU]
        load_g = float(self.proc[:, GPU] @ (1.0 - x)) / counts[GPU]
        return max(cp, load_c, load_g)


def chain(proc: np.ndarray) -> TaskGraph:
    """Convenience: a simple chain T_0 -> T_1 -> ... (used in tests)."""
    n = proc.shape[0]
    return TaskGraph.build(proc, [(i, i + 1) for i in range(n - 1)])
