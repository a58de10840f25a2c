"""The MoE capacity dispatch and ordered combine, and their backward: the
wrapper of ``csrc/moe_sm90.cu``.

The counterpart of the reference's XLA program for the sort-based capacity
MoE, ``repro.models.layers.moe_apply`` (``src/repro/models/layers.py:262``),
and of its ``jax.grad``: its stable argsort by expert with per-expert
positions, the scatter-add of the kept tokens into (E·cap, D) rows, and the
gated gather-back with its scatter-add into the tokens.  The expert
products between the dispatch and the combine stay ``torch.bmm`` (the
reference's ``einsum``s).  Five entries, each one plain version in
``ref.py``:

* :func:`route`: ``top_e`` (N, k) -> :class:`~.ref.Routing`.  Up to 32
  entries (a decode step) one warp ranks them in registers (a match, a
  popcount, a ballot); above that one thread-block cluster of up to 16
  blocks of 512 splits them into contiguous shares, counts each share per
  expert, reads every block's counts through distributed shared memory
  after ``cluster.sync()`` (each expert's base is the sum over the blocks
  before, in block order), then ranks its share tile by tile on top of
  those bases: the stable positions, with no sort and no global atomic.
  What bounds it: latency (a chain of barriers), not its bytes.
* :func:`dispatch`: x (N, D) -> (E·cap, D), in one of two orders by one
  shape rule (:func:`by_token`).  Where x fits the L2 (up to
  :data:`ROWS_IN_L2`: the serving shapes) the buffer's rows go in order, a
  block of 256 threads copying 8 KB of them (several rows where D is
  small), each row gathering its token's row of x.  Past it (the training
  shape, 16,384 tokens: x is 33.5-67 MB, the rows' gathers re-read each
  token row k times from device memory) the dispatch goes by token: up to
  264 zero blocks first, a warp a row, zero the rows no entry fills (each
  expert's rows past its count, from the routing's counts), then a block
  takes a few tokens, loads each token row once and stores it at the slot
  of every kept entry.  Every store streams, each thread's two 16-byte
  loads before its stores.  Where the routing may have dropped an entry
  (``Routing.may_drop``) and did, every block also checks its share of
  the dropped tokens' values and flags a non-finite one; the blocks take
  tickets as they finish and the last 264 wait for every copy, then, if a
  value was flagged, store NaN at the dropped entries' non-finite columns
  (the reference adds ``x · 0`` for them): one launch, ordered by the
  routing's counters (``Routing.scratch``, zeroed by the route and left at
  zero), so a routing's dispatches (and its :func:`combine_grad` calls)
  run one at a time.  Bounded by bytes.
* :func:`combine`: (E·cap, D) -> (N, D); a block takes one token or
  several (D·elem small), a thread a token sorts its k choices by expert
  into shared memory, then each thread issues its k row loads before the
  ordered adds, each product and add in fp32 rounded to the compute dtype
  (two values an instruction), which is the reference's bf16 arithmetic:
  the kernel equals the plain version bit for bit.  Bounded by bytes.
  With unit gates it is the dispatch's backward (:func:`dispatch_grad`).
* :func:`combine_grad`: the combine's cotangent for ho, dout (N, D) ->
  (E·cap, D): the dispatch's kernel, in its order, with a weight an entry
  (by token, read into shared memory with the slots), each kept row
  ``+0 + dout[token] · cdt(gate)``, zeros elsewhere, the same NaN pass for
  the dropped entries (``dout · 0``).  Bounded by bytes.
* :func:`gate_grad`: the combine's cotangent for the gates, (N, k) fp32:
  one warp an entry, in the order of XLA:CPU's program for the reference's
  VJP (``ref.xla_row_sum``): each lane sums its windows of 32 products in
  order, each product and add rounded to the compute dtype, the window
  sums summed again in windows, lane 0 the rest in order; +0 + sum ·
  ``keep``.  D a multiple of 32 up to 8192 (the kernel's windows are
  whole; the plain version takes any D).  Bounded by bytes: it reads the
  N·k rows its entries point at.

:func:`dispatch` and :func:`combine` run through ``torch.autograd.Function``
classes (``ref.Dispatch``, ``ref.Combine``): the routing passes through with no
gradient, and the backward takes the kernels on the card and the plain
versions on the CPU, as the forward does.

:func:`geometry` mirrors the launches' shapes (the route's cluster and
shares); :func:`launch_floor` launches an empty kernel as an entry
launches, the least time a launch of it can take.  The bytes: dispatch
reads each token row once and writes the E·cap rows (combine_grad also
the kept entries' gates); combine reads the N·k rows it gathers and writes
N rows; gate_grad reads the N token rows and the rows its entries point
at and writes N·k floats; route reads N·k ints.  ``torch.index_add_`` /
``scatter_add_`` on the card add with atomics in no fixed order, so no
PyTorch call gives these functions.

A tensor on the CPU takes the plain version; a tensor on the card launches
the kernel or raises.  Every launch adds one to its entry's counter
(:func:`launch_counts`).  A routing's dropped count is ``stats[-1]``, on
its device.
"""
from __future__ import annotations

import ctypes
import functools
import types

import torch

from repro_torch.kernels import build

from .ref import (WINDOW, Combine, Dispatch, Routing, capacity,
                  combine_grad_ref, combine_ref, dispatch_grad_ref,
                  dispatch_ref, gate_grad_ref, route_ref)

__all__ = ["Routing", "by_token", "capacity", "combine", "combine_grad",
           "dispatch", "dispatch_grad", "gate_grad", "geometry", "launch_count",
           "launch_counts", "launch_floor", "library_geometry",
           "reset_launch_count", "route"]

ENTRIES = ("route", "dispatch", "combine", "combine_grad", "gate_grad")
#: dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the route kernel's shared counts hold 64 experts
MAX_EXPERTS = 64
MAX_TOP_K = 8
#: gate_grad's windows a warp holds in shared memory (D up to 8192)
GATE_MAX_WINDOWS = 256
#: the kernel's launch constants (``moe_sm90.cu``), mirrored by :func:`geometry`
WARP_ENTRIES = 32
ROUTE_THREADS = 512
MAX_CLUSTER = 16
COPY_THREADS, COPY_UNROLL, COPY_TOKENS, COPY_SPREAD = 256, 2, 32, 128
ZERO_BLOCKS = 264                       # the dispatch's zero blocks at most
#: x's bytes up to which the dispatch visits the buffer's rows in order
#: (their gathers hit the L2); past it the dispatch goes by token
ROWS_IN_L2 = 16 << 20
COMBINE_THREADS, MAX_TOKENS = 256, 32
GATE_THREADS = 256                      # one warp an entry

_launches = dict.fromkeys(ENTRIES, 0)


def launch_count() -> int:
    """Launches of all entries since :func:`reset_launch_count`."""
    return sum(_launches.values())


def launch_counts() -> dict[str, int]:
    """Launches of each entry, by name (:data:`ENTRIES`); a dispatch (and
    a combine_grad) is its copy and, where the routing may have dropped an
    entry, its non-finite pass; :func:`dispatch_grad` launches the
    combine."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


@functools.cache
def _fns():
    lib = build.load("moe_sm90")
    route_fn = lib.moe_route_sm90
    route_fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p] * 7
    dispatch_fn = lib.moe_dispatch_sm90
    dispatch_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p] * 3
    combine_fn = lib.moe_combine_sm90
    combine_fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p] * 2
    combine_grad_fn = lib.moe_combine_grad_sm90
    combine_grad_fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p] * 3
    gate_grad_fn = lib.moe_gate_grad_sm90
    gate_grad_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p] * 2
    geometry_fn = lib.moe_geometry_sm90
    geometry_fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    floor_fn = lib.moe_floor_sm90
    floor_fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fns = {"route": route_fn, "dispatch": dispatch_fn, "combine": combine_fn,
           "combine_grad": combine_grad_fn, "gate_grad": gate_grad_fn,
           "geometry": geometry_fn, "floor": floor_fn}
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


def _call(name: str, dev: torch.device, args: list) -> None:
    """Launch ``name`` on ``dev``'s current stream; raises on a CUDA error.
    An entry's launch adds one to its counter, the floor's does not."""
    fn = _fns()[name]
    if len(args) + 1 != len(fn.argtypes):      # ctypes would pass the rest as int
        raise TypeError(f"moe {name}: {len(args)} arguments and the stream "
                        f"for {len(fn.argtypes)} parameters")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(idx):
        err = fn(*args, torch.cuda.current_stream(idx).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe {name} launch failed: CUDA error {err}")
    if name in _launches:
        _launches[name] += 1


def _div_up(a: int, b: int) -> int:
    return -(-a // b)


def by_token(n: int, d: int, elem: int) -> bool:
    """Whether the dispatch (and combine_grad) of N tokens of D columns of
    ``elem`` bytes goes by token (x's bytes past :data:`ROWS_IN_L2`: each
    token row read once) rather than through the buffer's rows in order:
    ``moe_sm90.cu``'s one shape rule between the two."""
    return n * d * elem > ROWS_IN_L2


def geometry(entry: str, n: int, k: int, d: int, e: int, cap: int,
             elem: int, cluster_max: int = MAX_CLUSTER) -> dict:
    """The launch of ``entry`` (one of :data:`ENTRIES`) at N tokens of k
    choices, D columns of ``elem`` bytes, E experts of ``cap`` rows, as
    ``moe_sm90.cu`` shapes it: ``blocks``, ``threads``, ``cluster`` (0: an
    ordinary launch) and ``per_block`` (route: entries, each block's
    contiguous share; dispatch and combine_grad: buffer rows in order, or
    by token (:func:`by_token`) a token block's tokens, after
    ``min(ceil(E·cap / 8), ZERO_BLOCKS)`` zero blocks of a warp a row;
    combine: tokens; gate_grad: entries, one a warp).  ``cluster_max`` is the
    largest route cluster the card co-schedules (the kernel probes it
    once)."""
    nk, vecs = n * k, d * elem // 16
    if entry == "route":
        if nk <= WARP_ENTRIES:
            return {"blocks": 1, "threads": 32, "cluster": 0, "per_block": nk}
        c = min(cluster_max, _div_up(nk, ROUTE_THREADS))
        return {"blocks": c, "threads": ROUTE_THREADS, "cluster": c,
                "per_block": _div_up(nk, c)}
    if entry in ("dispatch", "combine_grad") and not by_token(n, d, elem):
        rpb = max(1, COPY_THREADS * COPY_UNROLL // vecs)
        return {"blocks": _div_up(e * cap, rpb), "threads": COPY_THREADS,
                "cluster": 0, "per_block": rpb}
    if entry in ("dispatch", "combine_grad"):
        tpb = max(1, min(COPY_THREADS * COPY_UNROLL // vecs, COPY_TOKENS,
                         n // COPY_SPREAD))
        zero = min(_div_up(e * cap, COPY_THREADS // 32), ZERO_BLOCKS)
        return {"blocks": zero + _div_up(n, tpb), "threads": COPY_THREADS,
                "cluster": 0, "per_block": tpb}
    if entry == "combine":
        tpb = min(max(1, COMBINE_THREADS // vecs), MAX_TOKENS)
        return {"blocks": _div_up(n, tpb), "threads": COMBINE_THREADS,
                "cluster": 0, "per_block": tpb}
    if entry == "gate_grad":
        wpb = GATE_THREADS // 32
        return {"blocks": _div_up(nk, wpb), "threads": GATE_THREADS,
                "cluster": 0, "per_block": wpb}
    raise ValueError(f"no MoE entry {entry!r}; one of {ENTRIES}")


def _codes(entry: str, dtype: torch.dtype) -> tuple[int, int]:
    if entry not in ENTRIES or dtype not in DTYPES:
        raise ValueError(f"entry {entry!r} of {ENTRIES}, dtype {dtype} of "
                         f"{tuple(DTYPES)}")
    return ENTRIES.index(entry), DTYPES[dtype]


def library_geometry(entry: str, n: int, k: int, d: int, e: int, cap: int,
                     dtype: torch.dtype) -> dict:
    """:func:`geometry` as the built kernel computes it on the current
    card (its probed cluster size included)."""
    code, dt = _codes(entry, dtype)
    out = (ctypes.c_int * 4)()
    err = _fns()["geometry"](code, n, k, d, e, cap, dt, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"moe geometry failed: CUDA error {err}")
    return dict(zip(("blocks", "threads", "cluster", "per_block"), out))


def launch_floor(entry: str, n: int, k: int, d: int, e: int, cap: int,
                 dtype: torch.dtype, device: torch.device | str = "cuda"
                 ) -> None:
    """An empty kernel launched as ``entry`` launches at these shapes, on
    the current stream: timed as the entry is timed, the least a launch of
    it can take.  Counts as no launch of the entry."""
    code, dt = _codes(entry, dtype)
    _call("floor", torch.device(device), [code, n, k, d, e, cap, dt])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (autograd may hand a backward
    an expanded, strided or offset cotangent)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _check_cuda(*named: tuple[str, torch.Tensor]) -> None:
    """Every tensor contiguous on one card, the first (the rows the kernel
    moves in 16-byte vectors) 16-byte aligned."""
    dev = named[0][1].device
    for name, t in named:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every tensor on one card ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if named[0][1].data_ptr() % 16:
        raise ValueError(f"{named[0][0]} must be 16-byte aligned")


def route(top_e: torch.Tensor, num_experts: int, cap: int,
          distinct: bool = False) -> Routing:
    """Route ``top_e`` (N, k) integer experts into ``num_experts`` experts
    of ``cap`` rows each (:class:`~.ref.Routing`).  ``distinct``: each row
    holds k distinct experts in range, as ``torch.topk`` gives them; then
    no entry drops where cap >= N, and the routing says so
    (``may_drop``)."""
    if top_e.dim() != 2 or top_e.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"top_e must be (N, k) integers; got "
                         f"{tuple(top_e.shape)} {top_e.dtype}")
    n, k = top_e.shape
    if not (1 <= num_experts <= MAX_EXPERTS and 1 <= k <= MAX_TOP_K
            and 1 <= cap and n >= 1):
        raise ValueError(f"E={num_experts}, k={k}, cap={cap}, N={n}: the "
                         f"kernel takes 1-{MAX_EXPERTS} experts, top-k 1-"
                         f"{MAX_TOP_K} and at least one row and token")
    if num_experts * cap >= 2 ** 31 or n * k >= 2 ** 31:
        raise ValueError("the kernel takes 32-bit row and entry indices")
    top_e = top_e.int().contiguous()
    may_drop = not (distinct and cap >= n)
    if top_e.device.type == "cpu":
        return route_ref(top_e, num_experts, cap, may_drop)
    _check_cuda(("top_e", top_e))
    dev = top_e.device
    slot = torch.empty(n * k, dtype=torch.int32, device=dev)
    keep = torch.empty(n * k, dtype=torch.bool, device=dev)
    rows = torch.empty(num_experts * cap, dtype=torch.int32, device=dev)
    stats = torch.empty(num_experts + 1, dtype=torch.int32, device=dev)
    dropped = torch.empty(n * k, dtype=torch.int32, device=dev)
    scratch = torch.empty(3, dtype=torch.int32, device=dev)
    _call("route", dev, [top_e.data_ptr(), n, k, num_experts, cap,
                         slot.data_ptr(), keep.data_ptr(), rows.data_ptr(),
                         stats.data_ptr(), dropped.data_ptr(),
                         scratch.data_ptr()])
    return Routing(top_e, slot, keep, rows, stats, dropped, num_experts, cap,
                   may_drop, scratch)


def _check_rows(t: torch.Tensor, name: str) -> None:
    if t.dim() != 2 or t.dtype not in DTYPES:
        raise ValueError(f"{name} must be (rows, D) of {tuple(DTYPES)}; got "
                         f"{tuple(t.shape)} {t.dtype}")
    if (t.shape[1] * t.element_size()) % 16:
        raise ValueError(f"{name}: D={t.shape[1]} is not a whole number of "
                         "16-byte vectors")


def _check_dispatch(x: torch.Tensor, r: Routing, name: str) -> None:
    _check_rows(x, name)
    if x.shape[0] * r.top_k != r.slot.numel():
        raise ValueError(f"{name} has {x.shape[0]} tokens; the routing "
                         f"{r.slot.numel() // r.top_k}")
    if x.device.type != "cpu" and r.scratch is None:
        raise ValueError("the routing has no kernel counters: route on the "
                         "card with moe.route")


def _dispatch(x: torch.Tensor, r: Routing,
              gates: torch.Tensor | None = None) -> torch.Tensor:
    """The dispatch kernel's launch: x's rows to the (E·cap, D) buffer,
    each scaled by its entry's gate where ``gates`` is given
    (``combine_grad``)."""
    args = [("x", x), ("rows", r.rows), ("slot", r.slot), ("stats", r.stats),
            ("dropped", r.dropped), ("scratch", r.scratch)]
    if gates is not None:
        gates = gates.float().contiguous()
        args.append(("gates", gates))
    _check_cuda(*args)
    n, d = x.shape
    buf = torch.empty((r.rows.numel(), d), dtype=x.dtype, device=x.device)
    ptrs = [x.data_ptr(), r.rows.data_ptr(), r.slot.data_ptr(),
            r.stats.data_ptr(), r.dropped.data_ptr()]
    ints = [n, r.top_k, d, r.num_experts, r.cap, DTYPES[x.dtype],
            int(r.may_drop)]
    if gates is None:
        _call("dispatch", x.device, ptrs + ints + [r.scratch.data_ptr(),
                                                   buf.data_ptr()])
    else:
        _call("combine_grad", x.device, ptrs + [gates.data_ptr()] + ints
              + [r.scratch.data_ptr(), buf.data_ptr()])
    return buf


def _forward_dispatch(x: torch.Tensor, r: Routing) -> torch.Tensor:
    _check_dispatch(x, r, "x")
    if x.device.type == "cpu":
        return dispatch_ref(x, r)
    return _dispatch(x, r)


def combine_grad(dout: torch.Tensor, r: Routing, gates: torch.Tensor
                 ) -> torch.Tensor:
    """The combine's cotangent for ho: dout (N, D), gates (N, k) ->
    (E·cap, D) in dout's dtype (:func:`~.ref.combine_grad_ref`)."""
    _check_dispatch(dout, r, "dout")
    if gates.shape != r.top_e.shape:
        raise ValueError(f"gates {tuple(gates.shape)} do not fit the "
                         f"routing's {tuple(r.top_e.shape)} choices")
    if dout.device.type == "cpu":
        return combine_grad_ref(dout, r, gates)
    return _dispatch(_aligned(dout), r, gates)


def _check_combine(ho: torch.Tensor, r: Routing,
                   gates: torch.Tensor | None = None) -> None:
    _check_rows(ho, "ho")
    n, k = r.top_e.shape
    if ho.shape[0] != r.rows.numel() or (gates is not None
                                         and gates.shape != (n, k)):
        raise ValueError(f"ho {tuple(ho.shape)} and gates "
                         f"{None if gates is None else tuple(gates.shape)} "
                         f"do not fit the routing's {r.rows.numel()} rows "
                         f"and ({n}, {k}) choices")


def _forward_combine(ho: torch.Tensor, r: Routing, gates: torch.Tensor
                     ) -> torch.Tensor:
    _check_combine(ho, r, gates)
    if ho.device.type == "cpu":
        return combine_ref(ho, r, gates)
    gates = gates.float().contiguous()
    _check_cuda(("ho", ho), ("gates", gates), ("slot", r.slot),
                ("keep", r.keep), ("top_e", r.top_e))
    n, k = r.top_e.shape
    out = torch.empty((n, ho.shape[1]), dtype=ho.dtype, device=ho.device)
    _call("combine", ho.device, [ho.data_ptr(), r.slot.data_ptr(),
                                 r.keep.data_ptr(), gates.data_ptr(),
                                 r.top_e.data_ptr(), n, k, ho.shape[1],
                                 DTYPES[ho.dtype], out.data_ptr()])
    return out


def dispatch_grad(dbuf: torch.Tensor, r: Routing) -> torch.Tensor:
    """The dispatch's cotangent for x: dbuf (E·cap, D) -> (N, D), the
    combine with unit gates (:func:`~.ref.dispatch_grad_ref`); a launch
    of the combine."""
    if dbuf.device.type == "cpu":
        _check_combine(dbuf, r)
        return dispatch_grad_ref(dbuf, r)
    ones = torch.ones(r.top_e.shape, device=dbuf.device)
    return _forward_combine(_aligned(dbuf), r, ones)


def gate_grad(dout: torch.Tensor, ho: torch.Tensor, r: Routing
              ) -> torch.Tensor:
    """The combine's cotangent for the gates: dout (N, D), ho (E·cap, D) in
    one dtype -> (N, k) float32 (:func:`~.ref.gate_grad_ref`)."""
    _check_rows(dout, "dout")
    _check_combine(ho, r)
    n, k = r.top_e.shape
    if dout.shape != (n, ho.shape[1]) or dout.dtype != ho.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"fit {n} tokens of ho's {tuple(ho.shape[1:])} "
                         f"{ho.dtype}")
    if dout.device.type == "cpu":
        return gate_grad_ref(dout, ho, r)
    d = ho.shape[1]
    if d % WINDOW or d > WINDOW * GATE_MAX_WINDOWS:
        raise ValueError(f"gate_grad: D={d} is not a multiple of {WINDOW} "
                         f"up to {WINDOW * GATE_MAX_WINDOWS}: XLA pads a "
                         "ragged last window, which the kernel's windows of"
                         " whole 16-byte vectors do not")
    dout, ho = _aligned(dout), _aligned(ho)
    _check_cuda(("dout", dout), ("ho", ho), ("slot", r.slot),
                ("keep", r.keep))
    out = torch.empty((n, k), dtype=torch.float32, device=dout.device)
    _call("gate_grad", dout.device, [dout.data_ptr(), ho.data_ptr(),
                                     r.slot.data_ptr(), r.keep.data_ptr(),
                                     n, k, ho.shape[1], DTYPES[ho.dtype],
                                     out.data_ptr()])
    return out


#: the entries as ``ref.Dispatch`` and ``ref.Combine`` take them
_OPS = types.SimpleNamespace(dispatch=_forward_dispatch,
                             combine=_forward_combine,
                             dispatch_grad=dispatch_grad,
                             combine_grad=combine_grad, gate_grad=gate_grad)


def dispatch(x: torch.Tensor, r: Routing) -> torch.Tensor:
    """x (N, D) -> the (E·cap, D) expert buffer (:func:`~.ref.dispatch_ref`);
    differentiable in x (:func:`dispatch_grad`)."""
    return Dispatch.apply(x, r, _OPS)


def combine(ho: torch.Tensor, r: Routing, gates: torch.Tensor) -> torch.Tensor:
    """ho (E·cap, D) the experts' outputs and gates (N, k) -> (N, D) in ho's
    dtype (:func:`~.ref.combine_ref`); differentiable in ho
    (:func:`combine_grad`) and the gates (:func:`gate_grad`)."""
    return Combine.apply(ho, r, gates, _OPS)
