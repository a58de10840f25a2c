"""The chunked SSD scan, its backward and the decode step: the wrapper of
``csrc/ssd_sm90.cu``.

The counterpart of the reference's XLA device code for the Mamba-2 layer:
``repro.models.layers.ssm_apply``'s chunk recurrence (``chunk_step`` under
its ``lax.scan``, ``src/repro/models/layers.py:404-430``), its
``jax.grad``, and ``ssm_decode``'s state update and readout (``:474-478``).
Three entries, each one plain version in ``ref.py``:

* :func:`scan`: dt (b, s, nh) fp32, xh (b, s, nh, hd), B and C (b, s, ns) in
  the compute dtype, A (nh,) fp32, chunks of ``lc`` -> (y, the final
  state); differentiable through :class:`~.ref.Scan`, which saves the state
  entering each chunk (nc, b, nh, hd, ns) for the backward.  Two kernels a
  launch, every product on Hopper's tensor cores (``wgmma``): a block a
  (batch, head) walks the chunks in order (each chunk's cumsums, then its
  contribution to the state U^T B, U = r(sdecay x) computed in registers,
  the state carried in registers and the entering state written once);
  then a block a pair of 64-row tiles of a chunk (the first with the last)
  and a group of heads computes the scores C·B once for the group into
  shared memory and each head's outputs, the decay-weighted scores as A
  from registers times x, plus C times the entering state.
* :func:`scan_grad`: the VJP (:func:`~.ref.scan_grad_ref`), four kernels
  a launch, its products on Hopper's tensor cores (``wgmma``): one reverse
  pass over the chunks a (batch, head), with the cumsums and each chunk's
  state cotangent from its outputs; then a block a pair of 64-column tiles
  of a chunk and a group of heads, with the scores' cotangent dL computed
  once a tile and a head and summed over the group's heads in registers,
  each head's dx and its exponent sums; the exponents' reverse cumsum a
  (batch, chunk, head), folding the groups' score cotangents in group
  order; and dB and dC a tile of 64 rows, each one accumulator over every
  head.  An operand computed on its load (the decay-weighted scores, dy
  times the decay, sdecay x) goes in from registers, the block's two
  warpgroups each summing half of every k step; in bf16, where hd and lc
  are multiples of 32 and ns of 8, the operands that are bf16 in device
  memory come by TMA; the fp32 ones are split by the threads into 3xTF32
  planes.  No float atomics: two runs give the same bits.
* :func:`step`: one decode step, the state (b, nh, hd, ns) and the conv
  window updated in place, bit for bit its plain version in the state and
  the window: a block of four warps a group of rows p of a (batch, head),
  a row's ns values split into 16-byte vectors over a power-of-two group
  of lanes (16 at mamba2-130m's ns 128 in bf16, 2 at jamba's ns 16), the
  readout a lane's chunks in order, then a butterfly of shuffles over the
  row's lanes; the conv window's shift on its own blocks of the grid.

Every product rounds once to the compute dtype where the plain version
rounds.  In bf16 each of the forward's products is of two bf16 values (x,
B, C, the states, the decay-weighted scores and sdecay x rounded as the
plain version rounds them), exact on the tensor cores; the backward takes a
product of two bf16 values as an exact bf16 hi and lo, and an fp32 operand
through 3xTF32 (hi = tf32(v), lo = tf32(v - hi), three products); in fp32
every operand takes 3xTF32.  So both agree with the plain versions to the
order of fp32 sums.  In bf16, where hd and lc are multiples of 32 and ns
of 8, the operands that are bf16 in device memory come by TMA (the
forward's in 128-byte swizzled boxes of 64 columns).  What bounds them
(``ssd_sm90.cu``'s note): at mamba2-130m's training shape the scan moves
138.9 MB and does 19.89 GFLOP, the backward 196.1 MB and 39.78 GFLOP (twice
that on the tensor cores, with the splits); both are held back by the
threads' work around their products (the register fragments, the staged
planes, a barrier a step); the step is bound by the state's bytes (its
launch floor is most of it at the decode shapes).  No
PyTorch call computes these functions.  :func:`launch_floor` launches an
empty kernel as an entry launches its kernels, the least a launch of it
can take.

A tensor on the CPU takes the plain version; a tensor on the card launches
the kernel or raises, whatever ``cfg.use_kernels`` says.  Every launch adds
one to its entry's counter (:func:`launch_counts`).
"""
from __future__ import annotations

import ctypes
import functools
import types

import torch

from repro_torch.kernels import build

from .ref import Scan, scan_grad_ref, scan_ref, step_ref

__all__ = ["ENTRIES", "launch_count", "launch_counts", "launch_floor",
           "reset_launch_count", "scan", "scan_grad", "step",
           "workspace_floats"]

ENTRIES = ("scan", "scan_grad", "step")
#: dtype codes of the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's limits: a chunk of at most 256 steps; hd · ns state values
#: a (batch, head) held by one block of the reverse pass (the step takes
#: the same)
MAX_CHUNK = 256
MAX_STATE = 8192

_launches = dict.fromkeys(ENTRIES, 0)


def launch_count() -> int:
    """Launches of all entries since :func:`reset_launch_count`."""
    return sum(_launches.values())


def launch_counts() -> dict[str, int]:
    """Launches of each entry, by name (:data:`ENTRIES`)."""
    return dict(_launches)


def reset_launch_count() -> None:
    for name in _launches:
        _launches[name] = 0


@functools.cache
def _fns():
    lib = build.load("ssd_sm90")
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {"scan": lib.ssd_scan_sm90, "scan_grad": lib.ssd_scan_grad_sm90,
           "step": lib.ssd_step_sm90, "floor": lib.ssd_floor_sm90}
    fns["scan"].argtypes = [P] * 5 + [I] * 7 + [P, ctypes.c_longlong] + \
        [P] * 3 + [P]
    fns["scan_grad"].argtypes = [P] * 8 + [I] * 7 + [P, ctypes.c_longlong] + \
        [P] * 5 + [P]
    fns["step"].argtypes = [P] * 8 + [I] * 7 + [P, P]
    fns["floor"].argtypes = [I] * 8 + [P]
    for fn in fns.values():
        fn.restype = ctypes.c_int
    work = lib.ssd_workspace_floats
    work.argtypes = [I] * 8
    work.restype = ctypes.c_longlong
    fns["workspace"] = work
    return fns


def _call(name: str, dev: torch.device, args: list) -> None:
    """Launch ``name`` on ``dev``'s current stream; raises on a CUDA error.
    An entry's launch adds one to its counter, the floor's does not."""
    fn = _fns()[name]
    if len(args) + 1 != len(fn.argtypes):      # ctypes would pass the rest as int
        raise TypeError(f"ssd {name}: {len(args)} arguments and the stream "
                        f"for {len(fn.argtypes)} parameters")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    with torch.cuda.device(idx):
        err = fn(*args, torch.cuda.current_stream(idx).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd {name} launch failed: CUDA error {err}")
    if name in _launches:
        _launches[name] += 1


def workspace_floats(entry: str, b: int, s: int, nh: int, hd: int, ns: int,
                     lc: int, dtype: torch.dtype) -> int:
    """The floats of scratch the built kernel needs for ``entry`` (scan or
    scan_grad) at these shapes."""
    n = _fns()["workspace"](ENTRIES.index(entry), b, s, nh, hd, ns, lc,
                            DTYPES[dtype])
    if n < 0:
        raise ValueError(f"ssd {entry}: shapes {(b, s, nh, hd, ns, lc)} "
                         f"{dtype} not taken")
    return n


def _check_scan(dt, xh, Bmat, Cmat, A, lc) -> None:
    if xh.dim() != 4 or xh.dtype not in DTYPES:
        raise ValueError(f"xh must be (b, s, nh, hd) of {tuple(DTYPES)}; got "
                         f"{tuple(xh.shape)} {xh.dtype}")
    b, s, nh, hd = xh.shape
    ns = Bmat.shape[-1]
    if (dt.shape != (b, s, nh) or dt.dtype != torch.float32
            or A.shape != (nh,) or A.dtype != torch.float32):
        raise ValueError(f"dt {tuple(dt.shape)} {dt.dtype} and A "
                         f"{tuple(A.shape)} {A.dtype} must be float32 (b, s, "
                         f"nh) and (nh,) for xh {tuple(xh.shape)}")
    for name, t in (("B", Bmat), ("C", Cmat)):
        if t.shape != (b, s, ns) or t.dtype != xh.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must be (b, "
                             f"s, ns) in xh's {xh.dtype}")
    if not (1 <= lc <= MAX_CHUNK and s % lc == 0):
        raise ValueError(f"chunk {lc}: the sequence {s} must be whole chunks"
                         f" of 1-{MAX_CHUNK} steps")
    if hd * ns > MAX_STATE:
        raise ValueError(f"hd {hd} x ns {ns} is over the kernel's "
                         f"{MAX_STATE} state values a head")


def _on_card(*named: tuple[str, torch.Tensor]) -> list[torch.Tensor]:
    """The tensors contiguous, each on one card (the first's)."""
    dev = named[0][1].device
    out = []
    for name, t in named:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every tensor on one card ({dev})")
        out.append(t.contiguous())
    return out


def _forward_scan(dt, xh, Bmat, Cmat, A, lc):
    """(y, final state, states) of the scan: the kernel on the card, the
    plain version on the CPU."""
    _check_scan(dt, xh, Bmat, Cmat, A, lc)
    if xh.device.type == "cpu":
        return scan_ref(dt, xh, Bmat, Cmat, A, lc)
    xh, dt, Bmat, Cmat, A = _on_card(("xh", xh), ("dt", dt), ("B", Bmat),
                                     ("C", Cmat), ("A", A))
    b, s, nh, hd = xh.shape
    ns = Bmat.shape[-1]
    n = workspace_floats("scan", b, s, nh, hd, ns, lc, xh.dtype)
    work = torch.empty(n, dtype=torch.float32, device=xh.device)
    y = torch.empty_like(xh)
    final = torch.empty((b, nh, hd, ns), dtype=xh.dtype, device=xh.device)
    states = torch.empty((s // lc, b, nh, hd, ns), dtype=xh.dtype,
                         device=xh.device)
    _call("scan", xh.device, [dt.data_ptr(), xh.data_ptr(), Bmat.data_ptr(),
                              Cmat.data_ptr(), A.data_ptr(), b, s, nh, hd,
                              ns, lc, DTYPES[xh.dtype], work.data_ptr(), n,
                              y.data_ptr(), final.data_ptr(),
                              states.data_ptr()])
    return y, final, states


def scan_grad(dt, xh, Bmat, Cmat, A, lc, states, dy, dfinal=None):
    """The scan's VJP: the forward's inputs, its per-chunk ``states``, the
    cotangents dy and ``dfinal`` (None: zero) -> (dxh, ddt, dB, dC, dA)
    (:func:`~.ref.scan_grad_ref`)."""
    _check_scan(dt, xh, Bmat, Cmat, A, lc)
    b, s, nh, hd = xh.shape
    ns = Bmat.shape[-1]
    want = {"states": (s // lc, b, nh, hd, ns), "dy": (b, s, nh, hd),
            "dfinal": (b, nh, hd, ns)}
    for name, t in (("states", states), ("dy", dy), ("dfinal", dfinal)):
        if t is not None and (tuple(t.shape) != want[name]
                              or t.dtype != xh.dtype):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must be "
                             f"{want[name]} in {xh.dtype}")
    if xh.device.type == "cpu":
        return scan_grad_ref(dt, xh, Bmat, Cmat, A, lc, states, dy, dfinal)
    named = [("xh", xh), ("dt", dt), ("B", Bmat), ("C", Cmat), ("A", A),
             ("states", states), ("dy", dy)]
    if dfinal is not None:
        named.append(("dfinal", dfinal))
    xh, dt, Bmat, Cmat, A, states, dy, *rest = _on_card(*named)
    dfinal = rest[0] if rest else None
    n = workspace_floats("scan_grad", b, s, nh, hd, ns, lc, xh.dtype)
    work = torch.empty(n, dtype=torch.float32, device=xh.device)
    dxh = torch.empty_like(xh)
    ddt = torch.empty_like(dt)
    dB, dC = torch.empty_like(Bmat), torch.empty_like(Cmat)
    dA = torch.empty_like(A)
    _call("scan_grad", xh.device, [
        dt.data_ptr(), xh.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
        A.data_ptr(), states.data_ptr(), dy.data_ptr(),
        None if dfinal is None else dfinal.data_ptr(), b, s, nh, hd, ns, lc,
        DTYPES[xh.dtype], work.data_ptr(), n, dxh.data_ptr(), ddt.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), dA.data_ptr()])
    return dxh, ddt, dB, dC, dA


#: the entries as ``ref.Scan`` takes them
_OPS = types.SimpleNamespace(scan=_forward_scan, scan_grad=scan_grad)


def scan(dt, xh, Bmat, Cmat, A, lc):
    """The SSD recurrence over chunks of ``lc`` steps -> (y (b, s, nh, hd),
    the final state (b, nh, hd, ns)), in xh's dtype
    (:func:`~.ref.scan_ref`); differentiable in dt, xh, B, C and A
    (:func:`scan_grad`)."""
    return Scan.apply(dt, xh, Bmat, Cmat, A, lc, _OPS)


def step(state, conv, window, xh, dtv, A, Bv, Cv):
    """One decode step (:func:`~.ref.step_ref`): state (b, nh, hd, ns) and
    conv (b, cw-1, W) updated in place, conv from the step's whole window
    (b, cw, W); xh (b, nh, hd), dtv (b, nh) and A (nh,) fp32, Bv and Cv (b,
    ns) -> y (b, nh, hd).  One launch: blocks of rows p of each (batch,
    head), each row's values in 16-byte vectors over its lanes, then the
    conv shift's blocks; the state and the window bit for bit the plain
    version's, y summed over n in a fixed tree (each lane its chunks in
    order, then a butterfly over the row's lanes), so two runs agree bit
    for bit.  No value goes to the host."""
    b, nh, hd, ns = state.shape
    cdt = state.dtype
    if (cdt not in DTYPES or xh.shape != (b, nh, hd) or dtv.shape != (b, nh)
            or A.shape != (nh,) or Bv.shape != (b, ns) or Cv.shape != (b, ns)
            or conv.shape[0] != b or window.shape != (
                b, conv.shape[1] + 1, conv.shape[2])
            or any(t.dtype != cdt for t in (conv, window, xh, Bv, Cv))
            or dtv.dtype != torch.float32 or A.dtype != torch.float32):
        raise ValueError(
            f"step: state {tuple(state.shape)} {cdt}, conv "
            f"{tuple(conv.shape)}, window {tuple(window.shape)}, xh "
            f"{tuple(xh.shape)}, dtv {tuple(dtv.shape)}, A {tuple(A.shape)}, "
            f"B {tuple(Bv.shape)}, C {tuple(Cv.shape)} do not fit")
    if state.device.type == "cpu":
        return step_ref(state, conv, window, xh, dtv, A, Bv, Cv)
    if hd * ns > MAX_STATE:
        raise ValueError(f"hd {hd} x ns {ns} is over the kernel's "
                         f"{MAX_STATE} state values a head")
    if not (state.is_contiguous() and conv.is_contiguous()):
        raise ValueError("step writes the state and the conv window in "
                         "place: both must be contiguous")
    state, conv, window, xh, dtv, A, Bv, Cv = _on_card(
        ("state", state), ("conv", conv), ("window", window), ("xh", xh),
        ("dtv", dtv), ("A", A), ("B", Bv), ("C", Cv))
    y = torch.empty_like(xh)
    _call("step", state.device, [
        state.data_ptr(), conv.data_ptr(), window.data_ptr(), xh.data_ptr(),
        dtv.data_ptr(), A.data_ptr(), Bv.data_ptr(), Cv.data_ptr(), b, nh,
        hd, ns, conv.shape[1], conv.shape[2], DTYPES[cdt], y.data_ptr()])
    return y


def launch_floor(entry: str, b: int, s: int, nh: int, hd: int, ns: int,
                 lc: int, dtype: torch.dtype,
                 device: torch.device | str = "cuda") -> None:
    """An empty kernel launched with each of ``entry``'s grids, blocks and
    shared memory at these shapes, in order, on the current stream: timed
    as the entry is timed, the least a launch of it can take.  Counts as no
    launch of the entry (``step``: b sequences of nh heads of (hd, ns), ``s``
    the conv window's rows and ``lc`` its width)."""
    if entry not in ENTRIES or dtype not in DTYPES:
        raise ValueError(f"entry {entry!r} of {ENTRIES}, dtype {dtype} of "
                         f"{tuple(DTYPES)}")
    _call("floor", torch.device(device), [ENTRIES.index(entry), b, s, nh, hd,
                                          ns, lc, DTYPES[dtype]])
