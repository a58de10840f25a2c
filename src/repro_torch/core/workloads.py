"""Benchmark task graphs — Chameleon dense linear algebra + GGen fork-join.

Reproduces the paper's §6.1 benchmark *structurally exactly*: the five
Chameleon applications (getrf, posv, potrf, potri, potrs) at
nb_blocks ∈ {5, 10, 20} with the task counts of Table 4, and the fork-join
application of Table 5 (p ∈ {2,5,10} phases × width ∈ {100..500}) with the
paper's exact processing-time recipe.

Deviation log (see DESIGN.md §2): the original per-task times were StarPU
measurements on Xeon E7 + Tesla K20 (and i7 + GTX-970/K5200 for 3 types).
Without those traces we synthesize them from an analytical kernel cost model:
CPU time = flops / per-core-rate; accelerator time = flops / (peak ·
size-efficiency(block)) with kernel-class-specific peaks, plus seeded
lognormal noise.  Small factorization kernels (potrf/getrf/trtri) end up
*slower* on GPU while large gemm/syrk reach 20–40× — the same qualitative
heterogeneity the paper's traces exhibit.
"""
from __future__ import annotations

import numpy as np

from .dag import TaskGraph

BLOCK_SIZES = (64, 128, 320, 512, 768, 960)
NB_BLOCKS = (5, 10, 20)
CHAMELEON_APPS = ("getrf", "posv", "potrf", "potri", "potrs")

# flops(b) per kernel class (dense tiles b×b)
_FLOPS = {
    "gemm": lambda b: 2.0 * b ** 3,
    "syrk": lambda b: 1.0 * b ** 3,
    "trsm": lambda b: 1.0 * b ** 3,
    "trmm": lambda b: 1.0 * b ** 3,
    "potrf": lambda b: b ** 3 / 3.0,
    "getrf": lambda b: 2.0 * b ** 3 / 3.0,
    "trtri": lambda b: b ** 3 / 3.0,
    "lauum": lambda b: b ** 3 / 3.0,
    "trsv": lambda b: 2.0 * b ** 2,
}

# (cpu GFLOP/s per core, per-device-type [peak GFLOP/s, half-efficiency block])
_CPU_RATE = 15.0
_DEV = {
    1: {"gemm": (1000.0, 400.0), "syrk": (800.0, 400.0), "trsm": (250.0, 350.0),
        "trmm": (250.0, 350.0), "potrf": (60.0, 600.0), "getrf": (80.0, 600.0),
        "trtri": (60.0, 600.0), "lauum": (70.0, 600.0), "trsv": (5.0, 300.0)},
    2: {"gemm": (700.0, 300.0), "syrk": (560.0, 300.0), "trsm": (180.0, 280.0),
        "trmm": (180.0, 280.0), "potrf": (45.0, 500.0), "getrf": (60.0, 500.0),
        "trtri": (45.0, 500.0), "lauum": (50.0, 500.0), "trsv": (4.0, 250.0)},
}


def _times(names: list[str], block_size: int, num_types: int,
           seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = len(names)
    proc = np.zeros((n, num_types))
    for j, nm in enumerate(names):
        cls = nm.split("(")[0]
        fl = _FLOPS[cls](block_size)
        proc[j, 0] = fl / (_CPU_RATE * 1e9) * rng.lognormal(0.0, 0.08)
        for q in range(1, num_types):
            peak, b0 = _DEV[q][cls]
            eff = 1.0 / (1.0 + (b0 / block_size) ** 2)
            proc[j, q] = fl / (peak * 1e9 * eff) * rng.lognormal(0.0, 0.12)
    return proc * 1e3  # milliseconds


# ------------------------------------------------------------------- builders
class _Builder:
    def __init__(self):
        self.names: list[str] = []
        self.edges: list[tuple[int, int]] = []

    def task(self, name: str, deps: list[int]) -> int:
        j = len(self.names)
        self.names.append(name)
        self.edges.extend((d, j) for d in deps if d is not None and d >= 0)
        return j


def _potrf_phase(b: _Builder, N: int, prefix: str,
                 entry: dict[tuple, int] | None = None) -> dict[tuple, int]:
    """Tiled right-looking Cholesky task DAG.  Returns ids of output blocks
    {('diag', kk): POTRF_kk, ('low', i, kk): TRSM_{i,kk}} for chaining."""
    entry = entry or {}
    potrf: dict[int, int] = {}
    trsm: dict[tuple[int, int], int] = {}
    syrk_prev: dict[int, int] = {}
    gemm_prev: dict[tuple[int, int], int] = {}
    for kk in range(N):
        deps = [syrk_prev.get(kk, -1), entry.get(("diag", kk), -1)]
        potrf[kk] = b.task(f"{prefix}(%d)" % kk, deps)
        for i in range(kk + 1, N):
            deps = [potrf[kk], gemm_prev.get((i, kk), -1), entry.get(("low", i, kk), -1)]
            trsm[(i, kk)] = b.task(f"trsm({i},{kk})", deps)
        for i in range(kk + 1, N):
            syrk_prev[i] = b.task(f"syrk({i},{kk})",
                                  [trsm[(i, kk)], syrk_prev.get(i, -1)])
            for jj in range(kk + 1, i):
                gemm_prev[(i, jj)] = b.task(
                    f"gemm({i},{jj},{kk})",
                    [trsm[(i, kk)], trsm[(jj, kk)], gemm_prev.get((i, jj), -1)])
    out = {("diag", kk): potrf[kk] for kk in range(N)}
    out.update({("low", i, kk): t for (i, kk), t in trsm.items()})
    return out


def _potrs_phase(b: _Builder, N: int, lblocks: dict[tuple, int]) -> None:
    """Two triangular-solve sweeps (forward + backward) on one RHS block column."""
    upd: dict[int, int] = {}
    last_fwd: list[int] = []
    for kk in range(N):  # forward: L y = b
        t = b.task(f"trsm(f{kk})", [upd.get(kk, -1), lblocks.get(("diag", kk), -1)])
        last_fwd.append(t)
        for i in range(kk + 1, N):
            upd[i] = b.task(f"gemm(f{i},{kk})",
                            [t, upd.get(i, -1), lblocks.get(("low", i, kk), -1)])
    upd2: dict[int, int] = {}
    for kk in range(N - 1, -1, -1):  # backward: L^T x = y
        deps = [upd2.get(kk, -1), lblocks.get(("diag", kk), -1), last_fwd[kk]]
        t = b.task(f"trsm(b{kk})", deps)
        for i in range(kk):
            upd2[i] = b.task(f"gemm(b{i},{kk})",
                             [t, upd2.get(i, -1), lblocks.get(("low", kk, i), -1)])


def _getrf(b: _Builder, N: int) -> None:
    """Tiled right-looking LU (block pivoting ignored, as in Chameleon's getrf_nopiv)."""
    getrf: dict[int, int] = {}
    gemm_prev: dict[tuple[int, int], int] = {}
    for kk in range(N):
        getrf[kk] = b.task(f"getrf({kk})", [gemm_prev.get((kk, kk), -1)])
        trsm_u = {j: b.task(f"trsm(u{kk},{j})", [getrf[kk], gemm_prev.get((kk, j), -1)])
                  for j in range(kk + 1, N)}
        trsm_l = {i: b.task(f"trsm(l{i},{kk})", [getrf[kk], gemm_prev.get((i, kk), -1)])
                  for i in range(kk + 1, N)}
        for i in range(kk + 1, N):
            for j in range(kk + 1, N):
                gemm_prev[(i, j)] = b.task(
                    f"gemm({i},{j},{kk})",
                    [trsm_l[i], trsm_u[j], gemm_prev.get((i, j), -1)])


def chameleon(app: str, nb_blocks: int, block_size: int, num_types: int = 2,
              seed: int = 0) -> TaskGraph:
    """Build one Chameleon application DAG with synthesized processing times."""
    if app not in CHAMELEON_APPS:
        raise ValueError(f"unknown app {app!r}")
    b = _Builder()
    N = nb_blocks
    if app == "potrf":
        _potrf_phase(b, N, "potrf")
    elif app == "potrs":
        _potrs_phase(b, N, {})
    elif app == "posv":
        lb = _potrf_phase(b, N, "potrf")
        _potrs_phase(b, N, lb)
    elif app == "getrf":
        _getrf(b, N)
    elif app == "potri":
        # potrf ; trtri ; lauum — three chained phases with potrf-isomorphic
        # counts (Table 4: |potri| = 3·|potrf| exactly).
        lb = _potrf_phase(b, N, "potrf")
        tb = _potrf_phase(b, N, "trtri", entry=lb)
        _potrf_phase(b, N, "lauum", entry=tb)
    import zlib  # deterministic across processes (unlike builtin hash)
    dseed = zlib.crc32(f"{app}|{nb_blocks}|{block_size}|{seed}".encode())
    proc = _times(b.names, block_size, num_types, seed=dseed)
    return TaskGraph.build(proc, b.edges, names=b.names)


def fork_join(width: int, phases: int, num_types: int = 2,
              seed: int = 0) -> TaskGraph:
    """GGen-style fork-join with the paper's §6.1 processing-time recipe:
    CPU ~ N(p, p/4); per phase 5% of parallel tasks get acceleration in
    [0.1, 0.5] (GPU-slower), the rest in [0.5, 50]; same recipe per extra
    accelerator type."""
    rng = np.random.default_rng(seed)
    b = _Builder()
    prev = b.task("seq(0)", [])
    par_ids: list[list[int]] = []
    for ph in range(phases):
        ids = [b.task(f"par({ph},{w})", [prev]) for w in range(width)]
        par_ids.append(ids)
        prev = b.task(f"seq({ph + 1})", ids)
    n = len(b.names)
    cpu = np.maximum(rng.normal(phases, phases / 4.0, size=n), phases / 100.0)
    proc = np.zeros((n, num_types))
    proc[:, 0] = cpu
    for q in range(1, num_types):
        accel = np.ones(n)
        for ids in par_ids:
            ids = np.asarray(ids)
            nslow = max(1, int(round(0.05 * len(ids))))
            slow = rng.choice(ids, size=nslow, replace=False)
            fast = np.setdiff1d(ids, slow)
            accel[slow] = rng.uniform(0.1, 0.5, size=slow.size)
            accel[fast] = rng.uniform(0.5, 50.0, size=fast.size)
        # sequential fork/join tasks: mildly accelerated
        accel[accel == 1.0] = rng.uniform(0.5, 2.0, size=(accel == 1.0).sum())
        proc[:, q] = cpu / accel
    return TaskGraph.build(proc, b.edges, names=b.names)


# Machine configurations of §6.2 / §6.3.
OFFLINE_CONFIGS_2 = [(m, k) for m in (16, 32, 64, 128) for k in (2, 4, 8, 16)]
OFFLINE_CONFIGS_3 = [(m, k1, k2) for m in (16, 32, 64, 128)
                     for k1 in (2, 4, 8, 16) for k2 in (2, 4, 8, 16)]
