"""The MoE capacity dispatch and ordered combine: the wrapper of
``csrc/moe_sm90.cu``.

The counterpart of the reference's XLA program for the sort-based capacity
MoE, ``repro.models.layers.moe_apply`` (``src/repro/models/layers.py:262``):
its stable argsort by expert with per-expert positions, the scatter-add of
the kept tokens into (E·cap, D) rows, and the gated gather-back with its
scatter-add into the tokens.  The expert products between the dispatch and
the combine stay ``torch.bmm`` (the reference's ``einsum``s).  Three
entries, each one plain version in ``ref.py``:

* :func:`route`: ``top_e`` (N, k) -> :class:`~.ref.Routing`.  Up to 32
  entries (a decode step) one warp ranks them in registers (a match, a
  popcount, a ballot); above that one thread-block cluster of up to 16
  blocks of 512 splits them into contiguous shares, counts each share per
  expert, reads every block's counts through distributed shared memory
  after ``cluster.sync()`` (each expert's base is the sum over the blocks
  before, in block order), then ranks its share tile by tile on top of
  those bases: the stable positions, with no sort and no global atomic.
  What bounds it: latency (a chain of barriers), not its bytes.
* :func:`dispatch`: x (N, D) -> (E·cap, D); a block of 256 threads copies
  8 KB of the buffer (several rows where D is small), each thread's two
  16-byte loads before its streaming stores.  Where the routing may have
  dropped an entry (``Routing.may_drop``) and did, every block also checks
  its share of the dropped tokens' values and flags a non-finite one; the
  blocks take tickets as they finish and the last 264 wait for every
  copy, then, if a value was flagged, store NaN at the dropped entries'
  non-finite columns (the reference adds ``x · 0`` for them): one launch,
  ordered by the routing's counters (``Routing.scratch``, zeroed by the
  route and left at zero), so a routing's dispatches run one at a time.
  Bounded by bytes.
* :func:`combine`: (E·cap, D) -> (N, D); a block takes one token or
  several (D·elem small), a thread a token sorts its k choices by expert
  into shared memory, then each thread issues its k row loads before the
  ordered adds, each product and add in fp32 rounded to the compute dtype
  (two values an instruction), which is the reference's bf16 arithmetic:
  the kernel equals the plain version bit for bit.  Bounded by bytes.

:func:`geometry` mirrors the launches' shapes (the route's cluster and
shares); :func:`launch_floor` launches an empty kernel as an entry
launches, the least time a launch of it can take.  The bytes: dispatch
reads each token row once and writes the E·cap rows; combine reads the N·k
rows it gathers and writes N rows; route reads N·k ints.
``torch.index_add_`` / ``scatter_add_`` on the card add with atomics in no
fixed order, so no PyTorch call gives this function.

A tensor on the CPU takes the plain version; a tensor on the card launches
the kernel or raises.  Every launch adds one to its entry's counter
(:func:`launch_counts`).  Forward only: a call that autograd would record
raises ``RuntimeError`` (training the MoE needs the backward kernels).
A routing's dropped count is ``stats[-1]``, on its device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

from .ref import Routing, capacity, combine_ref, dispatch_ref, route_ref

__all__ = ["Routing", "capacity", "combine", "dispatch", "geometry",
           "launch_count", "launch_counts", "launch_floor",
           "library_geometry", "reset_launch_count", "route"]

ENTRIES = ("route", "dispatch", "combine")
#: dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the route kernel's shared counts hold 64 experts
MAX_EXPERTS = 64
MAX_TOP_K = 8
#: the kernel's launch constants (``moe_sm90.cu``), mirrored by :func:`geometry`
WARP_ENTRIES = 32
ROUTE_THREADS = 512
MAX_CLUSTER = 16
COPY_THREADS, COPY_UNROLL = 256, 2
COMBINE_THREADS, MAX_TOKENS = 256, 32

_launches = dict.fromkeys(ENTRIES, 0)


def launch_count() -> int:
    """Launches of the three entries since :func:`reset_launch_count`."""
    return sum(_launches.values())


def launch_counts() -> dict[str, int]:
    """Launches of each entry, by name (``route``, ``dispatch``,
    ``combine``); a dispatch is its copy and, where the routing may have
    dropped an entry, its non-finite pass."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


def _no_grad(*tensors: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the MoE dispatch and combine are forward only "
                           "(no backward kernel yet): serve under "
                           "torch.no_grad() or with inputs that need no grad")


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
    geometry_fn = lib.moe_geometry_sm90
    geometry_fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    floor_fn = lib.moe_floor_sm90
    floor_fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fns = {"route": route_fn, "dispatch": dispatch_fn, "combine": combine_fn,
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


def geometry(entry: str, n: int, k: int, d: int, e: int, cap: int,
             elem: int, cluster_max: int = MAX_CLUSTER) -> dict:
    """The launch of ``entry`` (``route``, ``dispatch``, ``combine``) at N
    tokens of k choices, D columns of ``elem`` bytes, E experts of ``cap``
    rows, as ``moe_sm90.cu`` shapes it (its first launch, for dispatch):
    ``blocks``, ``threads``, ``cluster`` (0: an ordinary launch) and
    ``per_block`` (route: entries, each block's contiguous share; dispatch:
    buffer rows; combine: tokens).  ``cluster_max`` is the largest route
    cluster the card co-schedules (the kernel probes it once)."""
    nk, vecs = n * k, d * elem // 16
    if entry == "route":
        if nk <= WARP_ENTRIES:
            return {"blocks": 1, "threads": 32, "cluster": 0, "per_block": nk}
        c = min(cluster_max, _div_up(nk, ROUTE_THREADS))
        return {"blocks": c, "threads": ROUTE_THREADS, "cluster": c,
                "per_block": _div_up(nk, c)}
    if entry == "dispatch":
        rpb = max(1, COPY_THREADS * COPY_UNROLL // vecs)
        return {"blocks": _div_up(e * cap, rpb), "threads": COPY_THREADS,
                "cluster": 0, "per_block": rpb}
    if entry == "combine":
        tpb = min(max(1, COMBINE_THREADS // vecs), MAX_TOKENS)
        return {"blocks": _div_up(n, tpb), "threads": COMBINE_THREADS,
                "cluster": 0, "per_block": tpb}
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


def dispatch(x: torch.Tensor, r: Routing) -> torch.Tensor:
    """x (N, D) -> the (E·cap, D) expert buffer (:func:`~.ref.dispatch_ref`)."""
    _no_grad(x)
    _check_rows(x, "x")
    if x.shape[0] * r.top_k != r.slot.numel():
        raise ValueError(f"x has {x.shape[0]} tokens; the routing "
                         f"{r.slot.numel() // r.top_k}")
    if x.device.type == "cpu":
        return dispatch_ref(x, r)
    if r.scratch is None:
        raise ValueError("the routing has no kernel counters: route on the "
                         "card with moe.route")
    _check_cuda(("x", x), ("rows", r.rows), ("slot", r.slot),
                ("stats", r.stats), ("dropped", r.dropped),
                ("scratch", r.scratch))
    n, d = x.shape
    buf = torch.empty((r.rows.numel(), d), dtype=x.dtype, device=x.device)
    _call("dispatch", x.device, [x.data_ptr(), r.rows.data_ptr(),
                                 r.slot.data_ptr(), r.stats.data_ptr(),
                                 r.dropped.data_ptr(), n, r.top_k, d,
                                 r.num_experts, r.cap, DTYPES[x.dtype],
                                 int(r.may_drop), r.scratch.data_ptr(),
                                 buf.data_ptr()])
    return buf


def combine(ho: torch.Tensor, r: Routing, gates: torch.Tensor) -> torch.Tensor:
    """ho (E·cap, D) the experts' outputs and gates (N, k) -> (N, D) in ho's
    dtype (:func:`~.ref.combine_ref`)."""
    _no_grad(ho, gates)
    _check_rows(ho, "ho")
    n, k = r.top_e.shape
    if ho.shape[0] != r.rows.numel() or gates.shape != (n, k):
        raise ValueError(f"ho {tuple(ho.shape)} and gates "
                         f"{tuple(gates.shape)} do not fit the routing's "
                         f"{r.rows.numel()} rows and ({n}, {k}) choices")
    if ho.device.type == "cpu":
        return combine_ref(ho, r, gates)
    gates = gates.float().contiguous()
    _check_cuda(("ho", ho), ("gates", gates), ("slot", r.slot),
                ("keep", r.keep), ("top_e", r.top_e))
    out = torch.empty((n, ho.shape[1]), dtype=ho.dtype, device=ho.device)
    _call("combine", ho.device, [ho.data_ptr(), r.slot.data_ptr(),
                                 r.keep.data_ptr(), gates.data_ptr(),
                                 r.top_e.data_ptr(), n, k, ho.shape[1],
                                 DTYPES[ho.dtype], out.data_ptr()])
    return out
