"""The first-order HLP solver — the paper's LP as a saddle-free descent on
the card.

The port's counterpart of the JAX package's ``repro.core.hlp_jax``.  The
module keeps the reference's name, so that the adapter ``hlp_jax_ols`` and
its metric keys (``hlp_jax_ols``, ``comm_hlp_jax_ols``,
``degrade_hlp_jax_ols``) read as they do in the reference's trajectory; it
imports no JAX.

The HLP relaxation is equivalent to the box-constrained convex program

    min_{x ∈ [0,1]^n}  f(x) = max( CP(x), load_CPU(x)/m, load_GPU(x)/k )

where CP(x) is the DAG longest path under fractional lengths
ℓ_j(x) = p̄_j x_j + p_j (1 - x_j).  It is minimized with Adam on logits
(x = σ(z)), a temperature-annealed soft longest path for the gradient, and
the best *exact* iterate kept.  Each solve is one launch of the CUDA kernel
``kernels/csrc/hlp_fo_sm90.cu`` (through ``kernels/hlp_fo/hlp_fo.py``),
which runs every Adam step in one block; on the CPU the wrapper takes the plain
version (``kernels/hlp_fo/ref.py``).  Two entry points: ``hybrid`` is the
reference's ``_solve`` (sigmoid, Q = 2, comm-free), ``choice`` its
``_solve_choice`` (a softmax over an ``AllocationProblem``'s (n, C) choice
grid, optionally with the expected crossing delay of every edge).

The starting logits are the reference's: ``z0 = 0.01 *
reference_normal(seed, shape)`` reproduces ``jax.random.normal(
jax.random.PRNGKey(seed), shape)`` in numpy to a few float32 ulp.  Every
solver also takes ``z0`` itself, so a test can feed the reference's own
draw.  Everything runs on the card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.hlp_fo import hlp_fo
from repro_torch.kernels.hlp_fo.ref import hard_longest_path, soft_longest_path

from .allocation import AllocationProblem, frac_objective
from .dag import CPU, GPU, TaskGraph
from .hlp import HLPSolution, canonical_round, canonical_round_moldable

__all__ = ["PaddedDag", "hard_longest_path", "reference_normal",
           "soft_longest_path", "solve_hlp_jax", "solve_mhlp_jax"]


@dataclasses.dataclass(frozen=True)
class PaddedDag:
    """Topo-ordered, pred-padded DAG in tensors on one device, with the
    topological levels and a successor CSR for the kernel.

    The reference's fields: ``topo`` (n,) int32; ``pred`` (n, P) int32, -1
    padded, rows aligned with task ids; ``pred_mask`` (n, P) bool; ``pc``,
    ``pg`` (n,) float32 CPU and GPU times; ``pred_comm`` (n, P) float32
    transfer cost of each pred slot (0 padded).  The kernel's:
    ``level_ptr`` (L + 1,) and ``level_task`` (n,) int32, the tasks sorted
    by level; ``succ_ptr`` (n + 1,), ``succ_task`` and ``succ_slot`` (E,)
    int32, each edge's successor and its slot in that successor's pred row;
    ``pred_edge`` (n, P) int32, each real pred slot's place in that CSR
    (-1 padded); ``pred_edge_topo`` (n, P) int32, the same in a CSR of the
    same ranges whose lists run in descending order of the successor's
    place in ``topo`` (the order in which the reference's reverse scan
    adds a task's successors' cotangents: the choice entry's);
    ``max_width``, the most tasks of one level, which sizes the block.
    """
    topo: torch.Tensor
    pred: torch.Tensor
    pred_mask: torch.Tensor
    pc: torch.Tensor
    pg: torch.Tensor
    pred_comm: torch.Tensor
    level_ptr: torch.Tensor
    level_task: torch.Tensor
    succ_ptr: torch.Tensor
    succ_task: torch.Tensor
    succ_slot: torch.Tensor
    pred_edge: torch.Tensor
    pred_edge_topo: torch.Tensor
    max_width: int

    @staticmethod
    def from_graph(g: TaskGraph, device: str | torch.device = "cuda"
                   ) -> "PaddedDag":
        dev = resolve_device(device)
        P = max(1, int(np.diff(g.pred_ptr).max()) if g.n else 1)
        pred = np.full((g.n, P), -1, dtype=np.int32)
        pcomm = np.zeros((g.n, P), dtype=np.float64)
        for j in range(g.n):
            pj = g.preds(j)
            pred[j, : pj.size] = pj
            pcomm[j, : pj.size] = g.comm[g.pred_edges(j)]
        level = np.asarray(g.level, dtype=np.int64)
        level_task = np.argsort(level, kind="stable").astype(np.int32)
        level_ptr = np.searchsorted(level[level_task],
                                    np.arange(int(level.max(initial=-1)) + 2))
        succ, slot = np.nonzero(pred >= 0)        # row-major: by successor
        src = pred[succ, slot]
        order = np.argsort(src, kind="stable")
        succ_ptr = np.concatenate([[0], np.cumsum(np.bincount(src,
                                                              minlength=g.n))])
        pred_edge = np.full((g.n, P), -1, dtype=np.int32)
        pred_edge[succ[order], slot[order]] = np.arange(order.size)
        pos = np.empty(g.n, dtype=np.int64)
        pos[g.topo] = np.arange(g.n)
        by_topo = np.lexsort((-pos[succ], src))
        pred_edge_topo = np.full((g.n, P), -1, dtype=np.int32)
        pred_edge_topo[succ[by_topo], slot[by_topo]] = np.arange(by_topo.size)

        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        i32, f32 = torch.int32, torch.float32
        return PaddedDag(
            topo=t(g.topo, i32), pred=t(pred, i32),
            pred_mask=t(pred >= 0, torch.bool),
            pc=t(g.proc[:, CPU], f32), pg=t(g.proc[:, GPU], f32),
            pred_comm=t(pcomm, f32), level_ptr=t(level_ptr, i32),
            level_task=t(level_task, i32), succ_ptr=t(succ_ptr, i32),
            succ_task=t(succ[order], i32), succ_slot=t(slot[order], i32),
            pred_edge=t(pred_edge, i32),
            pred_edge_topo=t(pred_edge_topo, i32),
            max_width=int(np.diff(level_ptr).max()))

    @property
    def n(self) -> int:
        return int(self.pred.shape[0])

    @property
    def levels(self) -> int:
        return int(self.level_ptr.shape[0]) - 1

    @functools.cached_property
    def pred_long(self) -> torch.Tensor:
        """``pred`` as int64, for indexing."""
        return self.pred.long()

    @functools.cached_property
    def level_slices(self) -> list[torch.Tensor]:
        """The tasks of each level, as int64 index tensors."""
        ptr = self.level_ptr.tolist()
        task = self.level_task.long()
        return [task[a:b] for a, b in zip(ptr[:-1], ptr[1:])]


# --------------------------------------------- the reference's random draw
def _threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash, 20 rounds, as ``jax._src.prng`` computes it."""
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    ks = (np.uint32(k1), np.uint32(k2),
          np.uint32(k1) ^ np.uint32(k2) ^ np.uint32(0x1BD11BDA))
    x = [x0 + ks[0], x1 + ks[1]]
    for i in range(5):
        for r in rotations[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def _poly_fma(x: np.ndarray, coeffs) -> np.ndarray:
    """Horner's rule in float32 with each step one fused multiply-add
    (exact in float64, rounded once)."""
    p = np.full(x.shape, np.float32(coeffs[0]), dtype=np.float32)
    x64 = x.astype(np.float64)
    for c in coeffs[1:]:
        p = (p.astype(np.float64) * x64 + np.float64(c)).astype(np.float32)
    return p


# XLA's float32 log1p below sqrt(2) - 1: a Cephes rational approximation
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# Giles' single-precision erfinv, the coefficients XLA uses for float32
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    large = np.log((x + f32(1)).astype(np.float64)).astype(f32)
    x2 = (x * x).astype(f32)
    small = (_poly_fma(x, _LOG1P_NUM) / _poly_fma(x, _LOG1P_DEN)).astype(f32)
    small = ((x * x2) * small).astype(f32)
    small = (f32(-0.5) * x2.astype(np.float64) + small).astype(f32)
    small = (x + small).astype(f32)
    return np.where(np.abs(x) < f32(0.41421356237309504880), small,
                    large).astype(f32)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    w = -_log1p_f32(-(x * x).astype(f32))
    lt = w < f32(5.0)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(lt, f32(_ERFINV_LT5[0]), f32(_ERFINV_GE5[0])).astype(f32)
    w64 = w.astype(np.float64)
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, f32(lo), f32(hi)).astype(np.float64)
        p = (p.astype(np.float64) * w64 + c).astype(f32)
    with np.errstate(over="ignore", invalid="ignore"):
        return np.where(np.abs(x) == f32(1), x * f32(np.inf),
                        (p * x).astype(f32)).astype(f32)


def reference_normal(seed: int, shape) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape)`` (float32, the
    default threefry key, ``jax_threefry_partitionable=True``) in numpy.

    The bits are the reference's exactly: Threefry-2x32 of the key
    ``(seed >> 32, seed & 0xFFFFFFFF)`` over the 64-bit element index split
    into its high and low words, the two output words xor-ed.  The map to
    a normal is XLA's float32 one (uniform on the mantissa in (-1, 1), then
    √2 · erfinv); its log1p and log agree with XLA's to within a few ulp,
    so a few values in a thousand differ from the reference's by 1-3 ulp.
    """
    shape = tuple(int(s) for s in np.atleast_1d(shape))
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    with np.errstate(over="ignore"):
        b1, b2 = _threefry2x32(seed >> 32, seed & 0xFFFFFFFF,
                               (idx >> np.uint64(32)).astype(np.uint32),
                               (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = (b1 ^ b2) >> np.uint32(9) | np.float32(1.0).view(np.uint32)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, floats * np.float32(2.0) + lo).astype(np.float32)
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).reshape(shape)


def _z0(seed: int, shape, z0, device) -> torch.Tensor:
    if z0 is None:
        z0 = np.float32(0.01) * reference_normal(seed, shape)
    z0 = torch.as_tensor(np.array(z0, dtype=np.float32), device=device)
    if tuple(z0.shape) != tuple(shape):
        raise ValueError(f"z0 has shape {tuple(z0.shape)}, expected "
                         f"{tuple(shape)}")
    return z0.contiguous()


# ----------------------------------------------------------------- solves
def _solve(d: PaddedDag, m: int, k: int, iters: int, seed: int, *,
           z0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_solve``: best x (n,) and its float32 λ, on
    ``d``'s device."""
    return hlp_fo.hybrid(d, _z0(seed, (d.n,), z0, d.pc.device), m=m, k=k,
                         iters=iters)


def _solve_choice(d: PaddedDag, p_choice: torch.Tensor, area: torch.Tensor,
                  type_mask: torch.Tensor, inv_counts: torch.Tensor,
                  iters: int, seed: int, use_comm: bool = False, *,
                  z0=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_solve_choice``: best x (n, C) and its λ."""
    z0 = _z0(seed, tuple(p_choice.shape), z0, p_choice.device)
    return hlp_fo.choice(d, z0, p_choice, area, type_mask, inv_counts,
                         iters=iters, use_comm=use_comm)


def _solve_problem(prob: AllocationProblem, iters: int, seed: int, *,
                   z0=None, device: str | torch.device = "cuda"
                   ) -> np.ndarray:
    """Run the choice-grid solve on an ``AllocationProblem`` and return the
    renormalized (n, C) fractional distribution."""
    dev = resolve_device(device)
    p_dev = np.where(prob.finite, prob.p_choice, 1e12)  # price out, keep
    #                                                     grads finite
    area = p_dev * prob.width_of.astype(np.float64)
    d = PaddedDag.from_graph(prob.g, dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    x, _ = _solve_choice(d, t(p_dev), t(area), t(prob.type_mask),
                         t(1.0 / np.asarray(prob.counts, dtype=np.float64)),
                         int(iters), int(seed), use_comm=prob.comm_aware,
                         z0=z0)
    x = x.cpu().numpy().astype(np.float64)
    x = np.where(prob.finite, x, 0.0)
    x /= x.sum(axis=1, keepdims=True)
    return x


def solve_mhlp_jax(g: TaskGraph, machine, iters: int = 400, seed: int = 0, *,
                   canonical: bool = False, comm_aware: bool = False,
                   z0=None, device: str | torch.device = "cuda"
                   ) -> HLPSolution:
    """First-order width-indexed MHLP — ``hlp.solve_mhlp``'s sibling.

    Optimizes a per-task softmax over the (type, width) choice grid of the
    shared ``AllocationProblem`` with the annealed soft longest path;
    ``comm_aware=True`` folds each edge's expected transfer cost into the
    path.  The returned ``lp_value`` is the *exact* λ of the best iterate,
    hence ≥ the HiGHS optimum.  ``canonical=True`` shares
    ``canonical_round_moldable`` with the exact solver.  ``z0`` replaces
    the seeded (n, C) starting logits.
    """
    from repro_torch.platform import as_platform

    platform = as_platform(machine)
    prob = AllocationProblem.build(g, platform, comm_aware=comm_aware)
    choices, p_choice = prob.choices, prob.p_choice
    x = _solve_problem(prob, iters, seed, z0=z0, device=device)
    val = frac_objective(prob, x)
    if canonical:
        alloc, width = canonical_round_moldable(g, platform, x, prob=prob)
    else:
        alloc = np.empty(g.n, dtype=np.int32)
        width = np.empty(g.n, dtype=np.int32)
        for j in range(g.n):
            cand = np.flatnonzero(x[j] >= x[j].max() - 1e-9)
            c = int(cand[np.lexsort((
                [choices[int(cc)][1] for cc in cand], p_choice[j, cand]))[0]])
            alloc[j], width[j] = choices[c]
    return HLPSolution(x_frac=x, lp_value=float(val), alloc=alloc,
                       width=width, status="first-order")


def solve_hlp_jax(g: TaskGraph, m: int, k: int, iters: int = 400,
                  seed: int = 0, *, canonical: bool = False,
                  comm_aware: bool = False, z0=None,
                  device: str | torch.device = "cuda") -> HLPSolution:
    """Drop-in replacement for ``hlp.solve_hlp`` (approximate, on the card).

    ``canonical=True`` routes the rounding through ``hlp.canonical_round``,
    making the allocation comparable task-wise with the exact solver's.
    ``comm_aware=True`` solves the rigid Q=2 choice grid through the
    ``choice`` entry (edge costs enter the soft longest path); the
    comm-free path is the ``hybrid`` entry.  ``z0`` replaces the seeded
    starting logits ((n,) comm-free, (n, 2) comm-aware).
    """
    if g.num_types != 2:
        raise ValueError("hybrid solver: Q must be 2")
    prob = AllocationProblem.build(g, (m, k), comm_aware=comm_aware,
                                   rigid=True)
    if prob.comm_aware:
        x2 = _solve_problem(prob, iters, seed, z0=z0, device=device)
        x = x2[:, CPU]
        val = frac_objective(prob, x2)
        alloc = (canonical_round(g, m, k, x, prob=prob) if canonical
                 else np.where(x >= 0.5, CPU, GPU).astype(np.int32))
        return HLPSolution(x_frac=x, lp_value=float(val), alloc=alloc,
                           status="first-order")
    d = PaddedDag.from_graph(g, device)
    x, _ = _solve(d, int(m), int(k), int(iters), int(seed), z0=z0)
    x = x.cpu().numpy().astype(np.float64)
    # λ(x) is exact for the returned iterate -> a *feasible* LP objective.
    val = g.lp_objective([m, k], x)
    alloc = (canonical_round(g, m, k, x) if canonical
             else np.where(x >= 0.5, CPU, GPU).astype(np.int32))
    return HLPSolution(x_frac=x, lp_value=float(val), alloc=alloc,
                       status="first-order")
