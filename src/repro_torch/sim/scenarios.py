"""Scenario generators for the simulation campaigns.

A ``Scenario`` bundles everything one simulation run needs: a ``TaskGraph``
of runtime estimates, a ``Machine``, and the seed that generated both.
Families cover the paper's §6.1 workloads and beyond:

  * ``chain``     — serial chain (no intra-parallelism; stresses allocation).
  * ``fork_join`` — GGen fork-join, the paper's Table-5 recipe
                    (via ``repro_torch.core.workloads.fork_join``).
  * ``layered``   — STG-style random layered DAG: ``layers`` ranks, random
                    width, edges only between consecutive ranks.
  * ``cholesky``  — tiled right-looking Cholesky (Chameleon ``potrf``).
  * ``lu``        — tiled LU without pivoting (Chameleon ``getrf``).
  * ``random``    — Erdős–Rényi-over-topological-order DAG (the tests'
                    workhorse shape).
  * ``netbound``  — ESTEE-style network-bound instance: wide layered DAG
                    whose edges cost as much as the tasks they connect, so
                    *where* data crosses the CPU/GPU boundary dominates the
                    makespan (communication-oblivious planners lose here).
  * ``from_workloads`` — bridge to any ``repro_torch.core.workloads.chameleon``
                    application (posv, potri, potrs, …).

Trace I/O (not a seeded family — takes a path, call directly):
``from_estee`` imports an ESTEE-format JSON workflow (durations +
data-transfer sizes mapped onto ``TaskGraph.comm``); ``to_estee`` is its
dual.

Synthetic families draw per-task CPU times and per-type speedups from the
paper's recipe: a small fraction of tasks is *slower* on the accelerator
(speedup in [0.1, 0.5]), the rest accelerated up to 50× — the qualitative
heterogeneity that makes the allocation phase matter.

Communication model: every family takes a ``ccr`` knob (communication-to-
computation ratio).  ``ccr > 0`` draws lognormal per-edge transfer costs
whose mean is ``ccr`` × the mean best-type task time — the cost is charged
by schedulers and engine whenever an edge crosses a type boundary (see
``repro_torch.core.dag.TaskGraph.comm``).  The edge-cost stream is drawn from a
*separate* seeded generator, so ``ccr=0`` (the default) is bit-for-bit the
pre-communication scenario — names, graphs, machines and golden makespans
all unchanged.

Every generator is a pure function of its parameters + ``seed``:
``make_scenario(family, seed=s, **params)`` always returns the same
scenario, which is what makes campaign sweeps and golden tests reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.dag import TaskGraph, amdahl_speedup
from repro_torch.core.workloads import chameleon, fork_join

from .engine import Machine


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    family: str
    graph: TaskGraph
    machine: Machine
    seed: int

    @property
    def counts(self) -> list[int]:
        return list(self.machine.counts)


# ------------------------------------------------------- processing times
def heterogeneous_times(n: int, num_types: int, rng: np.random.Generator, *,
                        cpu_mean: float = 10.0, slow_frac: float = 0.05,
                        speedup: tuple[float, float] = (0.5, 50.0),
                        cpu: np.ndarray | None = None) -> np.ndarray:
    """(n, Q) estimates: CPU ~ lognormal around ``cpu_mean``; each extra type
    accelerates most tasks by U[speedup] and *slows* a ``slow_frac`` fraction
    by U[0.1, 0.5] (the paper's §6.1 recipe).

    ``cpu`` optionally fixes the per-task reference times instead of drawing
    them — how trace importers reuse the speedup recipe verbatim."""
    if cpu is None:
        cpu = cpu_mean * rng.lognormal(0.0, 0.5, size=n)
    else:
        cpu = np.asarray(cpu, dtype=np.float64)
        if cpu.shape != (n,):
            raise ValueError(f"cpu must be ({n},), got {cpu.shape}")
    proc = np.empty((n, num_types))
    proc[:, 0] = cpu
    for q in range(1, num_types):
        acc = rng.uniform(*speedup, size=n)
        nslow = int(round(slow_frac * n))
        if nslow:
            slow = rng.choice(n, size=nslow, replace=False)
            acc[slow] = rng.uniform(0.1, 0.5, size=nslow)
        proc[:, q] = cpu / acc
    return proc


def _machine(counts, rng: np.random.Generator | None = None) -> Machine:
    if counts is not None:
        return Machine(tuple(counts))
    assert rng is not None
    m = int(rng.choice((4, 8, 16, 32)))
    k = int(rng.choice((1, 2, 4)))
    return Machine.hybrid(m, k)


# -------------------------------------------------------------- edge costs
def with_ccr(g: TaskGraph, ccr: float, seed: int, *,
             spread: float = 0.5) -> TaskGraph:
    """Attach lognormal per-edge transfer costs scaled to a target CCR.

    The communication-to-computation ratio is defined against the mean
    *best-type* task time (the work an ideal machine actually executes):
    ``mean(comm) == ccr * mean(min_q proc)``.  Costs come from their own
    generator stream (``default_rng([seed, 0xC0]``...) so adding/removing
    them never perturbs the task-time or machine draws — ``ccr == 0``
    returns the graph untouched.
    """
    if ccr <= 0.0 or not g.num_edges:
        return g
    rng = np.random.default_rng([seed, 0xC077])
    base = float(np.min(g.proc, axis=1).mean())
    comm = ccr * base * rng.lognormal(-0.5 * spread ** 2, spread,
                                      size=g.num_edges)
    return g.with_comm(comm)


def _ccr_tag(ccr: float) -> str:
    """Name suffix for comm-enabled scenarios (empty at ccr=0: names — and
    the golden tests keyed on them — stay stable)."""
    return f"_ccr{ccr:g}" if ccr > 0 else ""


# ------------------------------------------------------------------ families
def chain_scenario(n: int = 20, num_types: int = 2, counts=None,
                   seed: int = 0, ccr: float = 0.0, **kw) -> Scenario:
    rng = np.random.default_rng(seed)
    proc = heterogeneous_times(n, num_types, rng, **kw)
    g = with_ccr(TaskGraph.build(proc, [(i, i + 1) for i in range(n - 1)]),
                 ccr, seed)
    return Scenario(f"chain_n{n}_s{seed}{_ccr_tag(ccr)}", "chain", g,
                    _machine(counts, rng), seed)


def fork_join_scenario(width: int = 50, phases: int = 3, num_types: int = 2,
                       counts=None, seed: int = 0, ccr: float = 0.0) -> Scenario:
    rng = np.random.default_rng(seed)
    g = with_ccr(fork_join(width, phases, num_types=num_types, seed=seed),
                 ccr, seed)
    return Scenario(f"forkjoin_w{width}_p{phases}_s{seed}{_ccr_tag(ccr)}",
                    "fork_join", g, _machine(counts, rng), seed)


def layered_scenario(n: int = 60, layers: int = 6, p_edge: float = 0.35,
                     num_types: int = 2, counts=None, seed: int = 0,
                     ccr: float = 0.0, **kw) -> Scenario:
    """STG-style: tasks binned into ranks, edges between consecutive ranks."""
    rng = np.random.default_rng(seed)
    rank = np.sort(rng.integers(0, layers, size=n))
    edges = []
    for lo in range(layers - 1):
        a = np.flatnonzero(rank == lo)
        b = np.flatnonzero(rank == lo + 1)
        added = False
        for i in a:
            for j in b:
                if rng.random() < p_edge:
                    edges.append((int(i), int(j)))
                    added = True
        # keep consecutive ranks connected so the depth is really `layers`
        if a.size and b.size and not added:
            edges.append((int(rng.choice(a)), int(rng.choice(b))))
    proc = heterogeneous_times(n, num_types, rng, **kw)
    g = with_ccr(TaskGraph.build(proc, edges), ccr, seed)
    return Scenario(f"layered_n{n}_l{layers}_s{seed}{_ccr_tag(ccr)}", "layered",
                    g, _machine(counts, rng), seed)


def cholesky_scenario(nb_blocks: int = 5, block_size: int = 320,
                      num_types: int = 2, counts=None, seed: int = 0,
                      ccr: float = 0.0) -> Scenario:
    rng = np.random.default_rng(seed)
    g = with_ccr(chameleon("potrf", nb_blocks, block_size,
                           num_types=num_types, seed=seed), ccr, seed)
    return Scenario(f"cholesky_nb{nb_blocks}_b{block_size}_s{seed}"
                    f"{_ccr_tag(ccr)}", "cholesky", g, _machine(counts, rng),
                    seed)


def lu_scenario(nb_blocks: int = 5, block_size: int = 320,
                num_types: int = 2, counts=None, seed: int = 0,
                ccr: float = 0.0) -> Scenario:
    rng = np.random.default_rng(seed)
    g = with_ccr(chameleon("getrf", nb_blocks, block_size,
                           num_types=num_types, seed=seed), ccr, seed)
    return Scenario(f"lu_nb{nb_blocks}_b{block_size}_s{seed}{_ccr_tag(ccr)}",
                    "lu", g, _machine(counts, rng), seed)


def random_scenario(n: int = 25, p_edge: float = 0.15, num_types: int = 2,
                    counts=None, seed: int = 0, ccr: float = 0.0,
                    **kw) -> Scenario:
    rng = np.random.default_rng(seed)
    edges = [(i, j) for i in range(n) for j in range(i + 1, n)
             if rng.random() < p_edge]
    proc = heterogeneous_times(n, num_types, rng, **kw)
    g = with_ccr(TaskGraph.build(proc, edges), ccr, seed)
    return Scenario(f"random_n{n}_s{seed}{_ccr_tag(ccr)}", "random", g,
                    _machine(counts, rng), seed)


def netbound_scenario(width: int = 12, depth: int = 5, num_types: int = 2,
                      counts=None, seed: int = 0, ccr: float = 2.0) -> Scenario:
    """ESTEE-style network-bound instance (default CCR = 2).

    A ``depth``-layer lattice of ``width`` tasks with a shuffled butterfly
    between consecutive layers; every task is strongly GPU-accelerated but
    edges cost ~CCR× a task, so a planner that scatters layers across the
    type boundary drowns in transfers while a communication-aware one keeps
    each dependence chain on one side.
    """
    rng = np.random.default_rng(seed)
    n = width * depth
    edges = []
    for d in range(depth - 1):
        lo, hi = d * width, (d + 1) * width
        perm = rng.permutation(width)
        for i in range(width):
            edges.append((lo + i, hi + int(perm[i])))
            edges.append((lo + i, hi + (i + 1) % width))
    proc = heterogeneous_times(n, num_types, rng, slow_frac=0.25,
                               speedup=(2.0, 8.0))
    g = with_ccr(TaskGraph.build(proc, edges), ccr, seed)
    return Scenario(f"netbound_w{width}_d{depth}_s{seed}{_ccr_tag(ccr)}",
                    "netbound", g, _machine(counts, rng), seed)


def moldable_cholesky_scenario(nb_blocks: int = 4, block_size: int = 320,
                               num_types: int = 2, counts=(8, 4),
                               seed: int = 0, ccr: float = 0.0,
                               max_width: int = 4) -> Scenario:
    """Tiled Cholesky with *moldable* kernels (Prou et al.'s setting).

    Each Chameleon kernel class gets an Amdahl speedup curve whose parallel
    fraction reflects how tile kernels actually scale: gemm/syrk updates are
    embarrassingly parallel, triangular solves less so, and the panel
    factorization is the serial bottleneck.  Widths are capped by the larger
    pool.  The curve stream is separate from the task-time stream, so the
    underlying times and machine draws match the rigid ``cholesky`` family
    seed-for-seed — the width-1 restriction of this scenario IS the classic
    instance.
    """
    rng = np.random.default_rng(seed)
    g = chameleon("potrf", nb_blocks, block_size, num_types=num_types,
                  seed=seed)
    base = {"potrf": 0.60, "trsm": 0.78, "syrk": 0.88, "gemm": 0.93}
    crng = np.random.default_rng([seed, 0x301D])
    alpha = np.clip([base[nm.split("(")[0]] + crng.normal(0.0, 0.03)
                     for nm in g.names], 0.0, 0.98)
    machine = _machine(counts, rng)
    W = max(1, min(max_width, max(machine.counts)))
    g = with_ccr(g.with_speedup(amdahl_speedup(alpha, W)), ccr, seed)
    return Scenario(f"moldable_cholesky_nb{nb_blocks}_b{block_size}_s{seed}"
                    f"{_ccr_tag(ccr)}", "moldable_cholesky", g, machine, seed)


def from_workloads(app: str = "posv", nb_blocks: int = 5, block_size: int = 320,
                   num_types: int = 2, counts=None, seed: int = 0,
                   ccr: float = 0.0) -> Scenario:
    """Bridge: any Chameleon application from ``repro_torch.core.workloads``."""
    rng = np.random.default_rng(seed)
    g = with_ccr(chameleon(app, nb_blocks, block_size, num_types=num_types,
                           seed=seed), ccr, seed)
    return Scenario(f"{app}_nb{nb_blocks}_b{block_size}_s{seed}{_ccr_tag(ccr)}",
                    "workloads", g, _machine(counts, rng), seed)


# ---------------------------------------------------------------- trace I/O
def from_estee(path, *, counts=(8, 2), num_types: int = 2,
               bandwidth: float = 1.0, seed: int = 0,
               slow_frac: float = 0.05,
               speedup: tuple[float, float] = (0.5, 50.0)) -> Scenario:
    """Import an ESTEE-format JSON workflow as a scenario.

    The format (Böhm & Beránek's ESTEE serialization, reduced to what the
    machine model consumes) is ``{"tasks": [...]}`` where each task carries
    a ``duration`` (seconds on the reference/CPU type), optional
    ``durations`` (explicit per-type times, as ``to_estee`` writes), and
    ``outputs: [{"size": bytes, "consumers": [task ids]}]`` — each
    (task, consumer) pair becomes a DAG edge whose transfer cost is
    ``size / bandwidth``, landing on ``TaskGraph.comm``.  The raw object
    sizes survive as ``TaskGraph.size``, and every consumer of one output
    dict shares one ``TaskGraph.out_id`` — contended network models ship a
    shared output across a type boundary once, not once per edge.

    Tasks without explicit ``durations`` get the missing types synthesized
    with the paper's §6.1 speedup recipe from a generator seeded by
    ``seed`` — deterministic, so a trace always maps to the same scenario.
    """
    import json
    import os
    with open(path) as f:
        doc = json.load(f)
    tasks = doc["tasks"]
    n = len(tasks)
    ids = {t.get("id", i): i for i, t in enumerate(tasks)}
    rng = np.random.default_rng([seed, 0xE57EE])
    proc = np.empty((n, num_types))
    synth = []
    for i, t in enumerate(tasks):
        if "durations" in t:
            d = np.asarray(t["durations"], dtype=np.float64)
            if d.shape != (num_types,):
                raise ValueError(f"task {i}: durations must have {num_types} "
                                 f"entries, got {d.shape}")
            proc[i] = d
        else:
            synth.append(i)
    if synth:
        proc[synth] = heterogeneous_times(
            len(synth), num_types, rng, slow_frac=slow_frac, speedup=speedup,
            cpu=[float(tasks[i]["duration"]) for i in synth])
    edges, comm, sizes, out_ids = [], [], [], []
    next_oid = 0
    for i, t in enumerate(tasks):
        for out in t.get("outputs", ()):
            raw = float(out.get("size", 0.0))
            oid, next_oid = next_oid, next_oid + 1
            for c in out["consumers"]:
                edges.append((i, ids[c]))
                comm.append(raw / bandwidth)
                sizes.append(raw)
                out_ids.append(oid)
    names = [str(t.get("name", f"t{i}")) for i, t in enumerate(tasks)]
    g = TaskGraph.build(proc, edges, names=names,
                        comm=np.asarray(comm, dtype=np.float64),
                        size=np.asarray(sizes, dtype=np.float64),
                        out_id=np.asarray(out_ids, dtype=np.int64))
    tag = os.path.splitext(os.path.basename(str(path)))[0]
    return Scenario(f"estee_{tag}_s{seed}", "estee", g,
                    _machine(counts, rng), seed)


def to_estee(g: TaskGraph, path, *, bandwidth: float = 1.0) -> None:
    """Export a ``TaskGraph`` as ESTEE-format JSON (``from_estee``'s dual).

    Writes explicit per-type ``durations`` (plus the scalar ``duration`` =
    type-0 time for ESTEE compatibility) and one output per *data object*
    (edges sharing an ``out_id`` collapse into one output dict with all
    their consumers; sizeless graphs default to ``size = comm * bandwidth``,
    one object per edge), so ``from_estee(to_estee(g))`` round-trips
    ``proc``, the edge set, ``comm``, and the output-sharing structure.
    """
    import json
    sizes = g.data_sizes(bandwidth)
    oids = g.edge_out_ids()
    tasks = []
    for i in range(g.n):
        by_oid: dict[int, dict] = {}
        for j, e in zip(g.succs(i), g.succ_edges(i)):
            out = by_oid.setdefault(int(oids[e]),
                                    {"size": float(sizes[e]), "consumers": []})
            out["consumers"].append(int(j))
        outputs = [by_oid[k] for k in sorted(by_oid)]
        tasks.append({
            "id": i,
            "name": g.names[i] if g.names else f"t{i}",
            "duration": float(g.proc[i, 0]),
            "durations": [float(x) for x in g.proc[i]],
            "outputs": outputs,
        })
    with open(path, "w") as f:
        json.dump({"tasks": tasks}, f, indent=1)


# NOTE: ``from_estee`` is intentionally *not* in SCENARIO_FAMILIES — every
# registry entry is a seeded generator sharing the (counts, num_types, ccr,
# seed) knob contract (what ``JobFactory`` relies on); the trace importer
# needs a path and carries its comm in the trace, so call it directly.
SCENARIO_FAMILIES: dict[str, Callable[..., Scenario]] = {
    "chain": chain_scenario,
    "fork_join": fork_join_scenario,
    "layered": layered_scenario,
    "cholesky": cholesky_scenario,
    "lu": lu_scenario,
    "random": random_scenario,
    "netbound": netbound_scenario,
    "moldable_cholesky": moldable_cholesky_scenario,
    "from_workloads": from_workloads,
}


def moldable_suite(seed: int = 0, *, counts=(8, 4), num: int = 4,
                   ccr: float = 0.0) -> list[Scenario]:
    """The moldable campaign suite: ``num`` seeds of the moldable Cholesky
    family (the instances where width-aware allocation should pay).
    ``ccr > 0`` attaches transfer costs — the comm-aware moldable
    sub-campaign's instances; 0 (the default) is the historical suite."""
    return [moldable_cholesky_scenario(counts=counts, seed=seed + i, ccr=ccr)
            for i in range(num)]


def make_scenario(family: str, **params) -> Scenario:
    if family not in SCENARIO_FAMILIES:
        raise ValueError(f"unknown family {family!r}; "
                         f"have {sorted(SCENARIO_FAMILIES)}")
    return SCENARIO_FAMILIES[family](**params)


def default_suite(seed: int = 0, *, counts=(8, 2),
                  ccr: float = 0.0) -> list[Scenario]:
    """A small cross-family suite (≥ 5 families) for tests and smoke sweeps.

    ``ccr=0`` (the default) is the historical communication-free suite —
    same names, same graphs, same golden makespans."""
    return [
        chain_scenario(n=16, counts=counts, seed=seed, ccr=ccr),
        fork_join_scenario(width=20, phases=2, counts=counts, seed=seed + 1,
                           ccr=ccr),
        layered_scenario(n=40, layers=5, counts=counts, seed=seed + 2, ccr=ccr),
        cholesky_scenario(nb_blocks=4, counts=counts, seed=seed + 3, ccr=ccr),
        lu_scenario(nb_blocks=4, counts=counts, seed=seed + 4, ccr=ccr),
        random_scenario(n=24, counts=counts, seed=seed + 5, ccr=ccr),
    ]


def comm_suite(seed: int = 0, *, counts=(8, 2),
               ccr: float = 0.5) -> list[Scenario]:
    """The communication-aware campaign suite: every default family with a
    nonzero CCR plus the network-bound ESTEE-style instance."""
    return default_suite(seed=seed, counts=counts, ccr=ccr) + [
        netbound_scenario(width=10, depth=4, counts=counts, seed=seed + 6),
    ]
