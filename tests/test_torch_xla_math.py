"""XLA:CPU's float32 exp and log in the port, and the first-order LP's choice
solve on them (ROADMAP C6).

``repro_torch/kernels/hlp_fo/xla_math.py`` writes out the programs XLA:CPU
emits for ``jnp.exp`` and ``jnp.log`` (their polynomials, the fused
multiply-adds its backend contracts, the flush of denormals its runtime
runs with), and ``csrc/xla_math.cuh`` holds the same pair as CUDA device
functions.  Held here, on the CPU:

* both twins against ``jax.jit(jnp.exp)`` / ``jax.jit(jnp.log)`` bit for
  bit: every exponent, the clamps, ``FLT_MIN``, denormals, ±0, ±inf, NaN
  and 2^22 random bit patterns;
* the choice entry's anneal and bias-correction table
  (``ref.schedule(iters, xla=True)``) against the reference's own
  expressions under ``jit``;
* the plain choice solve (the twins, the table, each Adam moment one
  multiply-add and x's cotangent in the order of XLA's program for the
  solve) equal to the reference's best x on netbound seed 300, bit for bit,
  at 160, 250 and 300 iterations (``tests/torch_hlp_fo_netbound_pin.json``);
* the CUDA header compiled for the CPU (g++, no contraction, the
  intrinsics as host functions) equal to the torch twins bit for bit.
"""
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.hlp_jax as JH  # noqa: E402
import repro.sim.scenarios as JS  # noqa: E402
import repro_torch.core.hlp_jax as TH  # noqa: E402
import repro_torch.sim.scenarios as TS  # noqa: E402
from repro_torch.core.allocation import AllocationProblem  # noqa: E402
from repro_torch.kernels.hlp_fo import ref as R  # noqa: E402
from repro_torch.kernels.hlp_fo.xla_math import xla_exp_f32  # noqa: E402
from repro_torch.kernels.hlp_fo.xla_math import xla_log_f32  # noqa: E402

import hlp_fo_emulation as E  # noqa: E402

HERE = Path(__file__).resolve().parent
PIN = HERE / "torch_hlp_fo_netbound_pin.json"
CSRC = HERE.parent / "src" / "repro_torch" / "kernels" / "csrc"


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _same(got, want, what, payload=True):
    """Bit for bit; a NaN's payload too unless ``payload`` is False (then a
    NaN matches any NaN)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    differ = _bits(got) != _bits(want)
    if not payload:
        differ &= ~(np.isnan(got) & np.isnan(want))
    bad = np.nonzero(differ)[0]
    assert bad.size == 0, (
        f"{what}: {bad.size} of {got.size} differ, first "
        f"{[(float(v), float(got[i]), float(want[i])) for i, v in zip(bad[:4], got[bad[:4]])]}")


def _sweep(seed: int) -> np.ndarray:
    """Every exponent (both signs, five mantissas each), the clamps and
    their neighbours, FLT_MIN, denormals, ±0, ±inf, NaN, and 2^22 random
    bit patterns."""
    mant = np.array([0, 1, 0x2AAAAA, 0x400000, 0x7FFFFF], np.uint32)
    expo = np.arange(256, dtype=np.uint32) << 23
    grid = (expo[:, None] | mant[None, :]).reshape(-1)
    grid = np.concatenate([grid, grid | 0x80000000])
    edges = np.array([-87.8, 88.8, -87.33655, 88.72284, -88.0, 89.0,
                      1.1754944e-38, 1e-40, -1e-40, 0.0, -0.0, np.inf,
                      -np.inf, np.nan, 1.0, 0.70710677, 1.4142135],
                     np.float32).view(np.uint32)
    near = np.concatenate([edges + np.uint32(d) for d in (0, 1, 2)]
                          + [edges - np.uint32(d) for d in (1, 2)])
    rand = np.random.default_rng(seed).integers(0, 2 ** 32, 2 ** 22,
                                                dtype=np.uint64)
    return np.concatenate([grid, near, rand.astype(np.uint32)]).view(
        np.float32)


@pytest.mark.parametrize("name", ["exp", "log"])
def test_twin_is_xlas_bit_for_bit(name):
    x = _sweep({"exp": 0, "log": 1}[name])
    ref = {"exp": jnp.exp, "log": jnp.log}[name]
    twin = {"exp": xla_exp_f32, "log": xla_log_f32}[name]
    want = np.asarray(jax.jit(ref)(jnp.asarray(x)))
    got = twin(torch.from_numpy(x)).numpy()
    _same(got, want, name)
    # and on the range the solve feeds them, densely
    v = (np.linspace(-90, 90, 2 ** 20, dtype=np.float32) if name == "exp"
         else np.geomspace(1e-30, 1e4, 2 ** 20).astype(np.float32))
    _same(twin(torch.from_numpy(v)).numpy(),
          np.asarray(jax.jit(ref)(jnp.asarray(v))), f"{name}, dense")


def test_twins_flush_denormals_as_xla_does():
    """XLA:CPU runs with denormals flushed: a denormal input reads as 0
    (log gives -inf) and a denormal result is 0; torch's own functions keep
    them, and so differ there."""
    x = torch.tensor([1e-40, -1e-40, 1.1754942e-38])
    assert torch.equal(xla_log_f32(x), torch.full((3,), -torch.inf))
    assert torch.isfinite(torch.log(x[:1])).all()
    e = xla_exp_f32(torch.tensor([-87.5, -87.0]))
    assert e[0] == 0 and e[1] > 0 and torch.exp(torch.tensor(-87.5)) > 0
    with pytest.raises(TypeError):
        xla_exp_f32(torch.zeros(2, dtype=torch.float64))


@pytest.mark.parametrize("iters", [1, 2, 7, 160, 300])
def test_choice_schedule_is_the_references(iters):
    """τ's anneal factor and Adam's bias corrections as the reference's
    scan body computes them under ``jit`` (division by a constant turned
    into a product, a folded constant, contractions, XLA's exp, libm's
    powf), equal to ``ref.schedule(iters, xla=True)`` bit for bit; the
    hybrid entry's table is the one it was."""
    def body(c, i):
        frac = i.astype(jnp.float32) / max(iters - 1, 1)
        f = jnp.exp(jnp.log(1 / 8.0) * (1 - frac) + jnp.log(1 / 512.0) * frac)
        return c, (f, 1 - 0.9 ** (i + 1), 1 - 0.999 ** (i + 1))
    want = jax.jit(lambda: jax.lax.scan(
        body, 0, jnp.arange(iters, dtype=jnp.int32))[1])()
    got = R.schedule(iters, xla=True)
    for k, w in enumerate(want):
        _same(got[:, k].numpy(), np.asarray(w), f"column {k}, {iters}")
    assert not torch.equal(R.schedule(300, xla=True), R.schedule(300))


def _netbound_s300():
    a, b = JS.netbound_scenario(seed=300), TS.netbound_scenario(seed=300)
    prob = AllocationProblem.build(b.graph, b.counts, comm_aware=True,
                                   rigid=True)
    p_dev = np.where(prob.finite, prob.p_choice, 1e12)
    ins = [np.asarray(v, np.float32) for v in (
        p_dev, p_dev * prob.width_of.astype(np.float64), prob.type_mask,
        1.0 / np.asarray(prob.counts, np.float64))]
    return JH.PaddedDag.from_graph(a.graph), TH.PaddedDag.from_graph(
        b.graph, "cpu"), ins


@pytest.mark.parametrize("iters", [160, 250, 300])
def test_plain_choice_solve_is_the_references_bit_for_bit(iters):
    """C6 closed: on netbound seed 300 from the reference's z0 the plain
    choice solve's best x is the reference's, every bit, at 160, 250 and
    300 iterations (the pin, itself the reference's own output; the
    reference's own one-ulp spread there is 3.6e-5 in λ)."""
    _, td, ins = _netbound_s300()
    z0 = np.array(0.01 * jax.random.normal(jax.random.PRNGKey(0),
                                           ins[0].shape), np.float32)
    x, lam = R.choice_solve_ref(td, torch.from_numpy(z0),
                                *map(torch.from_numpy, ins), iters=iters,
                                use_comm=True)
    pinned = np.asarray(json.loads(PIN.read_text())[str(iters)]["x"],
                        np.float32)
    _same(x.numpy(), pinned, f"best x at {iters} iterations")
    assert torch.isfinite(lam)


def test_solve_orders_x_cotangent_as_xlas_solve_program():
    """Inside ``_solve_choice`` XLA adds the marginals' share of x's
    cotangent first; in a program of ``jax.grad(loss)`` alone, last.  The
    two orders give gradients a few ulps apart on netbound seed 300, and
    ``ref.choice_grad`` runs the solve's: the scan model
    (``choice_grad_xla_order``, test code) in the solve's order equals it
    bit for bit, in ``jax.grad``'s order it does not."""
    jd, td, ins = _netbound_s300()
    tins = [torch.from_numpy(a) for a in ins]
    z = torch.from_numpy(np.array(0.01 * jax.random.normal(
        jax.random.PRNGKey(0), ins[0].shape), np.float32))
    tau = tins[0].max() * R.schedule(300, xla=True)[0, 0]
    a = R.choice_grad(td, z, tau, *tins, True).numpy()
    arrs = tuple(np.asarray(v) for v in (jd.topo, jd.pred, jd.pred_mask,
                                         jd.pred_comm))
    kw = dict(
        exp=lambda v: xla_exp_f32(torch.from_numpy(np.array(v))).numpy(),
        log=lambda v: xla_log_f32(torch.from_numpy(np.array(v))).numpy())
    b = E.choice_grad_xla_order(*arrs, z.numpy(), tau.numpy(), *ins, **kw)
    diff = (a != b).sum()
    assert 0 < diff < a.size
    np.testing.assert_allclose(a, b, rtol=2e-6)
    _same(E.choice_grad_xla_order(*arrs, z.numpy(), tau.numpy(), *ins,
                                  in_solve=True, **kw), a, "solve's order")


_SHIM = r"""
#include <cmath>
#include <cstdint>
#include <cstring>
using std::isnan;
#define __device__
#define __forceinline__ inline
static inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
static inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
static inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
static inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
static inline float __uint_as_float(unsigned int u) { float f; std::memcpy(&f, &u, 4); return f; }
static inline float __int_as_float(int u) { float f; std::memcpy(&f, &u, 4); return f; }
static inline int __float_as_int(float f) { int u; std::memcpy(&u, &f, 4); return u; }
#include "xla_math.cuh"
extern "C" void run(const float* x, float* y, long n, int op) {
  for (long i = 0; i < n; ++i)
    y[i] = op == 0 ? xla_math::xla_exp_f32(x[i]) : xla_math::xla_log_f32(x[i]);
}
"""


def test_cuda_twins_compiled_for_the_cpu_are_the_torch_twins(tmp_path):
    """``csrc/xla_math.cuh`` built for the CPU with g++ (no contraction;
    ``__f*_rn`` as single roundings, ``__fmaf_rn`` as ``std::fma``; a
    stand-in ``cuda_runtime.h``) gives the torch twins' bits on the sweep
    (a NaN's payload aside: it follows each machine's propagation rule):
    the device functions are the same program.  The card tests hold the
    card's own build to the same twins."""
    (tmp_path / "cuda_runtime.h").write_text("#pragma once\n")
    (tmp_path / "twins.cpp").write_text(_SHIM)
    lib = tmp_path / "twins.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-ffp-contract=off",
                    "-fno-fast-math", "-shared", "-fPIC", f"-I{tmp_path}",
                    f"-I{CSRC}", str(tmp_path / "twins.cpp"), "-o", str(lib)],
                   check=True)
    run = ctypes.CDLL(str(lib)).run
    x = _sweep(2)
    for op, twin in ((0, xla_exp_f32), (1, xla_log_f32)):
        y = np.empty_like(x)
        run(x.ctypes.data_as(ctypes.c_void_p), y.ctypes.data_as(
            ctypes.c_void_p), ctypes.c_long(x.size), op)
        _same(y, twin(torch.from_numpy(x)).numpy(), f"op {op}",
              payload=False)
