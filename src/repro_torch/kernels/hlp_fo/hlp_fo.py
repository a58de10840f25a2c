"""The first-order LP's solves on the card: the wrapper of
``csrc/hlp_fo_sm90.cu``.

The counterpart of the JAX package's jitted ``repro.core.hlp_jax._solve``
(:func:`hybrid`: x = σ(z), Q = 2, comm-free) and ``::_solve_choice``
(:func:`choice`: x = softmax(z) over an (n, C) choice grid, optionally with
each pred edge's expected crossing delay): ``iters`` Adam steps on logits
from ``z0``, returning the iterate of least exact λ and that λ.  A tensor
on the CPU takes the plain version (``ref.py``); a tensor on the card
launches a kernel, one block for the whole solve, or raises.

The kernel (:data:`SOURCE`) walks the levels twice a step
(the exact pass fused into the next soft forward, and a reverse walk whose
successors push their stored edge adjoints), the chain rule and Adam off
the level chain.  The choice solve runs in the order of the program XLA:CPU
compiles for the reference's gradient, as its plain version does
(``ref.choice_grad``); its successor lists run in descending topological
order (``d.pred_edge_topo``).  Its arrays lie in shared memory where they fit
(:data:`LAYOUTS` ``"shared"``), else the per-task ones in a scratch buffer
on the card (``"global"``): :func:`layout_for` picks by size alone.  Its
first design, ``csrc/hlp_fo.cu`` (three walks a step, a reverse pass that
gathered from each successor), was deleted once this kernel took every
problem it took; ``tests/hlp_fo_emulation.py`` keeps its loop as an
independent model of the backward.

Every launch adds one to the kernel's counter (:func:`launch_count`),
under a lock: the campaign's planning threads launch concurrently.

``d`` holds the problem's DAG as ``repro_torch.core.hlp_jax.PaddedDag``
does: ``topo`` (n,) int32, a topological order (the order of the
reference's scans, which the choice solve's backward follows); ``pred``
(n, P) int32, -1 after the last real slot; ``pred_mask``
(n, P) bool; ``pc``, ``pg`` (n,) and ``pred_comm`` (n, P) float32;
``level_ptr`` (L + 1,) and ``level_task`` (n,) int32, the tasks sorted by
topological level; ``succ_ptr`` (n + 1,), ``succ_task`` and ``succ_slot``
(E,) int32, each edge's successor and its slot in that successor's row;
``pred_edge`` (n, P) int32, each real slot's place in that CSR, -1 after
the last; ``pred_edge_topo`` (n, P) int32, the same in a CSR of the same
ranges whose lists run in descending order of the successor's place in
``topo`` (the choice entry's); ``max_width``, the most tasks of one level
(an int on the host).
:func:`check_indices` holds these to each other (a few waits for the
card); :func:`launch_hybrid` and :func:`launch_choice` are the bare
launches, which check layouts and sizes only.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build

from .ref import choice_solve_ref, hybrid_solve_ref, schedule

__all__ = ["LAYOUTS", "MAX_C", "MAX_Q", "MAX_THREADS", "PHASES", "SMEM_LIMIT",
           "SOURCE", "chain_probe", "check_dag", "check_indices", "choice",
           "hybrid", "launch_choice",
           "launch_count", "launch_hybrid", "layout_for",
           "reset_launch_count", "smem_bytes", "threads_for",
           "transcendental"]

#: the kernel's source under ``csrc/``
SOURCE = "hlp_fo_sm90"
#: the sm90 kernel's layouts: its arrays in shared memory, or the per-task
#: ones in a scratch buffer on the card
LAYOUTS = ("shared", "global")
#: the phases of a step whose clock cycles a launch can return
PHASES = ("forward", "loss", "reverse", "adam")
MAX_C = 16                   # choices a task may have
MAX_Q = 8                    # resource types
MAX_THREADS = 512            # the kernels' largest block
SMEM_LIMIT = 232448          # 227 KB, the most a block may take on the H100
_MAX_V = MAX_C + 2           # values a reduction carries
_MAX_WARPS = MAX_THREADS // 32

_launches = 0
_lock = threading.Lock()

_INT = ("topo", "level_ptr", "level_task", "pred", "succ_ptr", "succ_task",
        "succ_slot", "pred_edge", "pred_edge_topo")
_FLOAT = ("pc", "pg", "pred_comm")


def launch_count() -> int:
    """Launches since the last :func:`reset_launch_count`."""
    with _lock:
        return _launches


def reset_launch_count() -> None:
    global _launches
    with _lock:
        _launches = 0


def threads_for(width: int) -> int:
    """Threads of one block: the widest level rounded up to a warp, at
    least one warp and at most :data:`MAX_THREADS`."""
    return min(MAX_THREADS, max(32, -(-width // 32) * 32))


def _task_floats(n: int, c: int, q: int, comm: bool, e: int) -> int:
    """The sm90 kernel's per-task arrays in floats: x (n C), the soft and
    hard finishes, each task's soft start and S + 1e-30 (4 n), the edge
    buffer (``e``, one an edge) and the type marginals (n Q, with
    ``comm``)."""
    return n * c + 4 * n + e + (n * q if comm else 0)


def smem_bytes(n: int, levels: int, c: int = 1, q: int = 0,
               comm: bool = False, *, e: int = 0,
               layout: str = "shared") -> int:
    """Dynamic shared memory of one block, as the kernel lays it out: in
    the ``"shared"`` layout its per-task arrays (``e`` the DAG's edges), in
    both the type mask and inverse counts, the level offsets and the
    reductions' scratch."""
    if layout not in LAYOUTS:
        raise ValueError(f"no layout {layout!r}; the layouts are {LAYOUTS}")
    floats = q * c + q + levels + 1 + _MAX_WARPS * _MAX_V
    if layout == "shared":
        floats += _task_floats(n, c, q, comm, e)
    return 4 * floats


def layout_for(n: int, levels: int, c: int = 1, q: int = 0,
               comm: bool = False, *, e: int = 0) -> str:
    """The sm90 kernel's layout for a problem, by size alone: ``"shared"``
    where it fits in :data:`SMEM_LIMIT`, else ``"global"``; raises where
    neither fits (more levels than shared memory holds offsets for)."""
    for layout in LAYOUTS:
        need = smem_bytes(n, levels, c, q, comm, e=e, layout=layout)
        if need <= SMEM_LIMIT:
            return layout
    raise ValueError(
        f"a problem of {n} tasks, {levels} levels and {c} choices needs "
        f"{need} bytes of shared memory in the sm90 kernel's global layout, "
        f"more than the {SMEM_LIMIT} a block may have")


@functools.cache
def _lib():
    lib = build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = (lib.hlp_fo_sm90_hybrid_f32, lib.hlp_fo_sm90_choice_f32,
           lib.hlp_fo_sm90_chain_probe, lib.hlp_fo_sm90_transcendental_f32)
    fns[0].argtypes = [p] * 18 + [i] * 8 + [p]
    fns[1].argtypes = [p] * 22 + [i] * 9 + [p]
    lib.hlp_fo_sm90_smem_bytes.argtypes = [i] * 7
    lib.hlp_fo_sm90_smem_bytes.restype = ctypes.c_longlong
    fns[2].argtypes = [p, i, i, p]
    fns[3].argtypes = [p, p, ctypes.c_longlong, i, p]
    for fn in fns:
        fn.restype = ctypes.c_int
    return lib


def check_dag(d) -> None:
    """Shapes, dtypes, contiguity and one device for the DAG's fields."""
    n, P = d.pred.shape
    want = {"topo": (n,), "level_ptr": (d.level_ptr.shape[0],),
            "level_task": (n,),
            "pred": (n, P), "pred_mask": (n, P), "succ_ptr": (n + 1,),
            "succ_task": (d.succ_task.shape[0],),
            "succ_slot": (d.succ_task.shape[0],), "pred_edge": (n, P),
            "pred_edge_topo": (n, P), "pc": (n,), "pg": (n,),
            "pred_comm": (n, P)}
    dev = d.pred.device
    for name, shape in want.items():
        t = getattr(d, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shape} (pred {(n, P)})")
        dtype = (torch.int32 if name in _INT else torch.float32
                 if name in _FLOAT else torch.bool)
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the solve takes {dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device} and pred on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n == 0 or d.level_ptr.shape[0] < 2:
        raise ValueError("an empty DAG: no tasks or no levels")


def check_indices(d) -> None:
    """Raise unless the levels partition the tasks in a topological order,
    ``topo`` is one too, every pred row is filled from the left with task
    ids, the mask marks its real slots, the successor CSR lists each real
    slot once, at its predecessor, ``pred_edge`` names each slot's place
    there, and ``pred_edge_topo`` each slot's place in a CSR of the same
    ranges whose lists run in descending ``topo`` order."""
    n, P = d.pred.shape
    lp, lt = d.level_ptr.long(), d.level_task.long()
    pred = d.pred.long()
    real = pred >= 0
    bad = ((lp[0] != 0) | (lp[-1] != n) | (lp[1:] < lp[:-1]).any()
           | (lt < 0).any() | (lt >= n).any() | (pred < -1).any()
           | (pred >= n).any() | (d.pred_mask != real).any()
           | (real[:, 1:] & ~real[:, :-1]).any())
    if bool(bad):
        raise ValueError("level_ptr, level_task, pred or pred_mask out of "
                         "range, pred not filled from the left, or pred_mask "
                         "not pred >= 0")
    level = torch.empty(n, dtype=torch.long, device=lt.device)
    level[lt] = torch.repeat_interleave(
        torch.arange(lp.shape[0] - 1, device=lt.device), lp[1:] - lp[:-1])
    seen = torch.zeros(n, dtype=torch.long, device=lt.device)
    seen.index_add_(0, lt, torch.ones_like(lt))
    sp, st, ss = d.succ_ptr.long(), d.succ_task.long(), d.succ_slot.long()
    E = st.shape[0]
    bad = ((seen != 1).any() | ((lp[1:] - lp[:-1]).max() != d.max_width)
           | ((level[pred.clamp_min(0)] >= level[:, None]) & real).any()
           | (sp[0] != 0) | (sp[-1] != E) | (sp[1:] < sp[:-1]).any()
           | (E != real.sum()) | (st < 0).any() | (st >= n).any()
           | (ss < 0).any() | (ss >= P).any())
    if not bool(bad) and E:
        src = torch.repeat_interleave(torch.arange(n, device=lt.device),
                                      sp[1:] - sp[:-1])
        bad = ((pred[st, ss] != src).any()
               | (d.pred_edge.long()[st, ss]
                  != torch.arange(E, device=lt.device)).any())
    bad = bad | ((d.pred_edge >= 0) != real).any()
    if not bool(bad):
        bad = _bad_topo_edges(d, pred, real, sp)
    if bool(bad):
        raise ValueError("the levels are not a topological partition of the "
                         "tasks (of widest level max_width), the successor "
                         "CSR does not list each pred slot once at its "
                         "predecessor, pred_edge does not name each "
                         "slot's place there, or topo and pred_edge_topo "
                         "do not order them topologically")


def _bad_topo_edges(d, pred, real, sp) -> torch.Tensor:
    """Whether ``topo`` is not a topological order or ``pred_edge_topo``
    not a placement of the real slots in ``sp``'s ranges, each list in
    descending ``topo`` place (two slots of one successor, a repeated
    edge, in slot order)."""
    n, P = pred.shape
    dev = pred.device
    topo = d.topo.long()
    if bool((topo < 0).any() | (topo >= n).any()):
        return torch.tensor(True)
    pos = torch.full((n,), -1, dtype=torch.long, device=dev)
    pos[topo] = torch.arange(n, device=dev)
    bad = (pos < 0).any() | ((pos[pred.clamp_min(0)] >= pos[:, None])
                             & real).any()
    pe = d.pred_edge_topo.long()
    E = int(real.sum())
    bad = bad | ((pe >= 0) != real).any()
    if bool(bad) or E == 0:
        return bad
    place = pe[real]
    if bool((place >= E).any()):
        return torch.tensor(True)
    slot = torch.full((E,), -1, dtype=torch.long, device=dev)
    slot[place] = torch.nonzero(real.reshape(-1)).reshape(-1)
    if bool((slot < 0).any()):
        return torch.tensor(True)
    src = torch.repeat_interleave(torch.arange(n, device=dev),
                                  sp[1:] - sp[:-1])
    at = pos[slot // P]
    late = ((at[1:] > at[:-1])
            | ((at[1:] == at[:-1]) & (slot[1:] <= slot[:-1])))
    return ((pred.reshape(-1)[slot] != src).any()
            | (late & (src[1:] == src[:-1])).any())


@functools.cache
def _schedule_on(iters: int, device: torch.device) -> torch.Tensor:
    """``ref.schedule(iters)`` on ``device``, copied there once."""
    return schedule(iters).to(device)


def _check_z0(z0: torch.Tensor, shape: tuple, device) -> None:
    if tuple(z0.shape) != shape or z0.dtype != torch.float32:
        raise ValueError(f"z0 is {z0.dtype} {tuple(z0.shape)}; expected "
                         f"float32 {shape}")
    if z0.device != device or not z0.is_contiguous():
        raise ValueError(f"z0 must be contiguous on {device}")


def _launch(entry: str, d, pointers: list, dims: list,
            iters: int, nC: int, z0: torch.Tensor, cycles,
            scratch: int = 0, pred_edge: torch.Tensor | None = None):
    """Allocate the Adam state (and the choice entry's softmax exps), the
    outputs and ``scratch`` floats (the global layout; 0 for none), launch,
    count.  ``pred_edge`` stands in for ``d.pred_edge``."""
    dev = d.pred.device
    if dev.type != "cuda":
        raise ValueError(f"the DAG is on {dev}; the kernel needs the card")
    state = torch.empty((4 if entry == "choice" else 3, nC),
                        dtype=torch.float32, device=dev)
    best_x = torch.empty(nC, dtype=torch.float32, device=dev)
    best_val = torch.empty((), dtype=torch.float32, device=dev)
    sched = _schedule_on(iters, dev)
    ptrs = [d.level_ptr, d.level_task, d.pred, d.succ_ptr, d.succ_task,
            d.succ_slot, d.pred_edge if pred_edge is None else pred_edge]
    args = ([t.data_ptr() for t in ptrs] + pointers
            + [sched.data_ptr(), z0.data_ptr()]
            + [row.data_ptr() for row in state]
            + [best_x.data_ptr(), best_val.data_ptr()])
    buf = (torch.empty(scratch, dtype=torch.float32, device=dev)
           if scratch else None)
    args.append(None if buf is None else buf.data_ptr())
    args.append(None if cycles is None else _cycles_ptr(cycles, dev))
    name = f"hlp_fo_sm90_{entry}_f32"
    n, P = d.pred.shape
    dims = [n, P, d.succ_task.shape[0], d.level_ptr.shape[0] - 1] + dims
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(_lib(), name)(*args, *dims,
                                          threads_for(d.max_width), stream)
    if err != 0:
        raise RuntimeError(f"{SOURCE}.cu launch failed: CUDA error "
                           f"{err}")
    global _launches
    with _lock:
        _launches += 1
    return best_x, best_val


def _cycles_ptr(cycles: torch.Tensor, dev) -> int:
    k = len(PHASES)
    if (tuple(cycles.shape) != (k,) or cycles.dtype != torch.int64
            or cycles.device != dev):
        raise ValueError(f"cycles must be int64 ({k},) on {dev}")
    return cycles.data_ptr()


def _check_size(d, c: int, q: int, comm: bool, layout: str | None = None
                ) -> int:
    """Raise unless the problem fits ``layout`` (by default
    :func:`layout_for`'s); return the floats of scratch its launch needs:
    the per-task arrays in the global layout, else 0."""
    n = d.pred.shape[0]
    levels = d.level_ptr.shape[0] - 1
    E = d.succ_task.shape[0]
    fits = layout_for(n, levels, c, q, comm, e=E)
    if layout is None:
        layout = fits
    elif layout not in LAYOUTS or LAYOUTS.index(layout) < LAYOUTS.index(fits):
        raise ValueError(f"a problem of {n} tasks, {levels} levels and {c} "
                         f"choices takes the {fits} layout, not {layout!r}")
    return 0 if layout == "shared" else _task_floats(n, c, q, comm, E)


def _check_choice(d, z0, p_choice, area, type_mask, inv_counts) -> None:
    n = d.pred.shape[0]
    if p_choice.dim() != 2 or p_choice.shape[0] != n or type_mask.dim() != 2:
        raise ValueError(f"p_choice {tuple(p_choice.shape)} and type_mask "
                         f"{tuple(type_mask.shape)}: expected (n, C) with "
                         f"n = {n}, and (Q, C)")
    C, Q = p_choice.shape[1], type_mask.shape[0]
    for name, t, shape in (("p_choice", p_choice, (n, C)),
                           ("area", area, (n, C)),
                           ("type_mask", type_mask, (Q, C)),
                           ("inv_counts", inv_counts, (Q,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}; "
                             f"expected float32 {shape}")
        if t.device != d.pred.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {d.pred.device}")
    _check_z0(z0, (n, C), d.pred.device)


def launch_hybrid(d, z0: torch.Tensor, *, m: int, k: int, iters: int,
                  cycles: torch.Tensor | None = None,
                  layout: str | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bare launch of the hybrid solve on the card: checks layouts and
    sizes, not indices (:func:`check_indices` is the caller's).  Given an
    int64 (4,) ``cycles`` tensor on the card, the kernel writes thread 0's
    clock cycles in each phase of :data:`PHASES`, summed over the
    steps.  ``layout="global"`` puts a problem that fits shared memory in
    the scratch buffer all the same (the same solve, bit for bit)."""
    check_dag(d)
    n = d.pred.shape[0]
    _check_z0(z0, (n,), d.pred.device)
    if m <= 0 or k <= 0 or iters < 0:
        raise ValueError(f"m, k = {m}, {k} and iters = {iters}: the solve "
                         "takes m, k >= 1 and iters >= 0")
    scratch = _check_size(d, 1, 0, False, layout)
    return _launch("hybrid", d, [d.pc.data_ptr(), d.pg.data_ptr()],
                   [iters, m, k], iters, n, z0, cycles, scratch)


def launch_choice(d, z0: torch.Tensor, p_choice: torch.Tensor,
                  area: torch.Tensor, type_mask: torch.Tensor,
                  inv_counts: torch.Tensor, *, iters: int, use_comm: bool,
                  cycles: torch.Tensor | None = None,
                  layout: str | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bare launch of the choice solve on the card, as
    :func:`launch_hybrid`."""
    check_dag(d)
    _check_choice(d, z0, p_choice, area, type_mask, inv_counts)
    (n, C), Q = p_choice.shape, type_mask.shape[0]
    if iters < 0:
        raise ValueError(f"iters = {iters}; the solve takes iters >= 0")
    if not (1 <= C <= MAX_C and 1 <= Q <= MAX_Q):
        raise ValueError(f"C = {C} choices and Q = {Q} types: the kernel "
                         f"takes 1 to {MAX_C} and 1 to {MAX_Q}")
    scratch = _check_size(d, C, Q, use_comm, layout)
    best_x, best_val = _launch(
        "choice", d,
        [p_choice.data_ptr(), area.data_ptr(), type_mask.data_ptr(),
         inv_counts.data_ptr(), d.pred_comm.data_ptr()],
        [C, Q, iters, int(bool(use_comm))], iters, n * C, z0, cycles,
        scratch, d.pred_edge_topo)
    return best_x.view(n, C), best_val


def hybrid(d, z0: torch.Tensor, *, m: int, k: int, iters: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``_solve`` from logits ``z0`` (n,) on ``m`` CPUs and ``k`` GPUs: the
    best x (n,) float32 and its exact λ (a float32 scalar), on ``d``'s
    device: the plain version for CPU tensors, the kernel on the card."""
    check_dag(d)
    _check_z0(z0, (d.pred.shape[0],), d.pred.device)
    if m <= 0 or k <= 0 or iters < 0:
        raise ValueError(f"m, k = {m}, {k} and iters = {iters}: the solve "
                         "takes m, k >= 1 and iters >= 0")
    check_indices(d)
    if d.pred.device.type == "cpu":
        return hybrid_solve_ref(d, z0, m=m, k=k, iters=iters)
    return launch_hybrid(d, z0, m=m, k=k, iters=iters)


def choice(d, z0: torch.Tensor, p_choice: torch.Tensor, area: torch.Tensor,
           type_mask: torch.Tensor, inv_counts: torch.Tensor, *, iters: int,
           use_comm: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``_solve_choice`` from logits ``z0`` (n, C): ``p_choice`` and
    ``area`` (n, C), ``type_mask`` (Q, C) and ``inv_counts`` (Q,), all
    float32; ``use_comm`` adds each pred edge's expected crossing delay.
    The best x (n, C) and its exact λ, as :func:`hybrid`."""
    check_dag(d)
    _check_choice(d, z0, p_choice, area, type_mask, inv_counts)
    if iters < 0:
        raise ValueError(f"iters = {iters}; the solve takes iters >= 0")
    check_indices(d)
    if d.pred.device.type == "cpu":
        return choice_solve_ref(d, z0, p_choice, area, type_mask, inv_counts,
                                iters=iters, use_comm=use_comm)
    return launch_choice(d, z0, p_choice, area, type_mask, inv_counts,
                         iters=iters, use_comm=use_comm)


def transcendental(x: torch.Tensor, op: str) -> torch.Tensor:
    """The card's float32 ``expf`` (``op="exp"``) or ``logf`` (``"log"``) of
    each entry of ``x`` (float32, on the card), as the choice kernel takes
    them; not a solve and not counted.  ``choice_solve_ref`` given these in
    place of torch's is the kernel's solve bit for bit."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"x is {x.dtype} on {x.device}; the card's "
                         "transcendentals take float32 on the card")
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().hlp_fo_sm90_transcendental_f32(
            x.data_ptr(), out.data_ptr(), x.numel(),
            {"exp": 0, "log": 1}[op], stream)
    if err != 0:
        raise RuntimeError(f"hlp_fo_sm90_transcendental_f32 failed: CUDA "
                           f"error {err}")
    return out


def chain_probe(steps: int, threads: int,
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Launch the chain-floor probe (``hlp_fo_sm90_chain_probe``): ``steps``
    barrier-separated level steps of ``threads`` threads (not counted as
    a solve)."""
    out = torch.empty(1, dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _lib().hlp_fo_sm90_chain_probe(out.data_ptr(), steps,
                                                   threads, stream)
    if err != 0:
        raise RuntimeError(f"hlp_fo_sm90_chain_probe failed: CUDA error "
                           f"{err}")
    return out
