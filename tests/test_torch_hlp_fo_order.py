"""The first-order LP's choice solve in the reference's rounding order
(ROADMAP C6).

The plain version (``repro_torch/kernels/hlp_fo/ref.py``) writes the choice
solve's gradient and exact λ out in the order of the program XLA:CPU
compiles for ``repro.core.hlp_jax._solve_choice`` (``ref.choice_grad``,
``ref.choice_lam``), and the kernel (``csrc/hlp_fo_sm90.cu``) does the same.
Held here, on the CPU:

* the float32 fused multiply-add and XLA's window-of-32 sums against exact
  rational arithmetic;
* ``ref.choice_grad`` against ``jax.grad`` of the reference's loss bit for
  bit on the netbound instances (given XLA's own exp and log), and against
  the independent scan-by-scan model ``tests/hlp_fo_emulation.py::
  choice_grad_xla_order`` bit for bit at step 1 and along a trajectory;
* the reordered plain version within the reference's own one-ulp spread on
  netbound seed 300 at 160, 250 and 300 iterations, allocations identical;
  the reference's best x there equal to the pin
  ``tests/torch_hlp_fo_netbound_pin.json``, which ``chip_smoke.py`` and the
  card tests hold the kernel to (remake it with ``JAX_PLATFORMS=cpu
  PYTHONPATH=src:tests python -c "import test_torch_hlp_fo_order as t;
  t.write_pin()"``);
* the hybrid solve unchanged: still autograd's gradient, bit for bit;
* the sm90 kernel's emulation (both designs) equal to the reordered plain
  version bit for bit, gradients and whole solves, and the choice entry's
  successor lists in descending topological order.
"""
import dataclasses
import fractions
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.hlp_jax as JH  # noqa: E402
import repro.sim.scenarios as JS  # noqa: E402
import repro_torch.core.hlp_jax as TH  # noqa: E402
import repro_torch.core.workloads as TW  # noqa: E402
import repro_torch.sim.scenarios as TS  # noqa: E402
from repro_torch.core.allocation import AllocationProblem  # noqa: E402
from repro_torch.core.allocation import frac_objective  # noqa: E402
from repro_torch.kernels.hlp_fo import hlp_fo as HF  # noqa: E402
from repro_torch.kernels.hlp_fo import ref as R  # noqa: E402

import hlp_fo_emulation as E  # noqa: E402

#: the reference's own λ spread on netbound seed 300 at 300 iterations
#: under one-ulp changes, the largest measured
#: (``tests/test_torch_hlp_fo.py::test_references_own_one_ulp_spread_on_netbound``)
SPREAD = 3.6e-5
#: the reference's best x on netbound seed 300 at each of :data:`ITERS`
PIN = Path(__file__).resolve().parent / "torch_hlp_fo_netbound_pin.json"
ITERS = (160, 250, 300)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _same(a, b, what):
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


def _torch_fn(fn):
    """A float32 numpy map through a torch function (the plain version's
    transcendentals)."""
    def apply(v):
        return fn(torch.from_numpy(np.array(v, np.float32))).numpy()
    return apply


def _jax_fn(fn):
    jitted = jax.jit(fn)

    def apply(v):
        arr = v.numpy() if hasattr(v, "numpy") else v
        return torch.from_numpy(np.array(jitted(np.asarray(arr, np.float32))))
    return apply


def _inputs(g, machine, comm, rigid):
    prob = AllocationProblem.build(g, machine, comm_aware=comm, rigid=rigid)
    p_dev = np.where(prob.finite, prob.p_choice, 1e12)
    ins = [np.asarray(a, np.float32) for a in (
        p_dev, p_dev * prob.width_of.astype(np.float64), prob.type_mask,
        1.0 / np.asarray(prob.counts, np.float64))]
    return prob, ins


def _netbound(seed):
    a, b = JS.netbound_scenario(seed=seed), TS.netbound_scenario(seed=seed)
    prob, ins = _inputs(b.graph, b.counts, True, True)
    return (JH.PaddedDag.from_graph(a.graph),
            TH.PaddedDag.from_graph(b.graph, "cpu"), prob, ins)


def _z0(seed, shape, scale=0.01):
    return np.array(scale * jax.random.normal(jax.random.PRNGKey(seed),
                                              shape), np.float32)


def _tau(p, step=0, iters=300):
    return np.float32(p.max() * R.schedule(iters)[step, 0].item())


def _exact_fma(a, b, c):
    """a * b + c rounded once to float32 (nearest, ties to even), from the
    exact rational value."""
    F = fractions.Fraction
    exact = F(float(a)) * F(float(b)) + F(float(c))
    near = np.float32(float(exact))
    cands = [np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(F(float(v)) - exact),
                                     int(np.float32(v).view(np.int32)) & 1))


def test_fma_is_one_rounding():
    """``ref.fma`` and the emulation's ``_fma`` round a * b + c once, as
    the exact value rounds; a float64 sum rounded again to float32 does
    not always (double rounding)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (rng.standard_normal(4000) * 10.0 ** rng.integers(-12, 12, 4000)
         ).astype(np.float32)
    # a double-rounding case: (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24 lies half
    # a float32 ulp above 1 + 2^-11, and c = 2^-80 lifts it past the tie,
    # below float64's resolution: the float64 sum is the tie, which rounds
    # to even (down), where the exact value rounds up
    u = np.float32(1.0 + 2.0 ** -12)
    a = np.concatenate([a, [u]]).astype(np.float32)
    b = np.concatenate([b, [u]]).astype(np.float32)
    c = np.concatenate([c, [np.float32(2.0 ** -80)]]).astype(np.float32)
    want = np.array([_exact_fma(x, y, z) for x, y, z in zip(a, b, c)],
                    np.float32)
    got = R.fma(*map(torch.from_numpy, (a, b, c))).numpy()
    _same(got, want, "ref.fma")
    _same(E._fma(a, b, c), want, "emulation _fma")
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive.view(np.int32) != want.view(np.int32)).sum() >= 1


def test_window_sum_is_xlas_order():
    """Windows of 32 with the padding split between the ends: the first
    window of 60 values holds 30 (2 of padding before them)."""
    rng = np.random.default_rng(1)
    for n in (1, 31, 32, 33, 60, 100, 257):
        v = (rng.standard_normal((n, 3)) * 10.0 ** rng.integers(-6, 6, (n, 1))
             ).astype(np.float32)
        got = R.window_sum(torch.from_numpy(v)).numpy()
        _same(got, E._window_sum(v), f"n={n}")
        lo = (-(-n // 32) * 32 - n) // 2
        want = np.zeros(3, np.float32)
        for start in range(-lo, n, 32):
            part = np.zeros(3, np.float32)
            for row in v[max(start, 0):start + 32]:
                part = (part + row).astype(np.float32)
            want = (want + part).astype(np.float32)
        _same(got, want, f"n={n} by hand")


def test_choice_grad_is_jax_grad_bit_for_bit_on_netbound():
    """``ref.choice_grad`` given XLA's own exp and log equals
    ``jax.jit(jax.grad(loss))`` of ``_solve_choice``'s loss (its inputs
    traced arguments) in every entry, on netbound seeds 300 and 301, at
    the reference's z0 and at logits 50 times larger."""
    def loss(z, tau, p, area, tm, inv, d):
        x = jax.nn.softmax(z, axis=1)
        X = x @ tm.T
        delay = d.pred_comm * (1.0 - jnp.einsum("npq,nq->np", X[d.pred], X))
        cp = JH.soft_longest_path(d, (p * x).sum(axis=1), tau, delay)
        loads = (tm @ (area * x).sum(axis=0)) * inv
        terms = jnp.concatenate([jnp.stack([cp]), loads])
        mx = jnp.max(terms)
        return mx + tau * jnp.log(jnp.sum(jnp.exp((terms - mx) / tau)))
    grad = jax.jit(jax.grad(loss))
    for seed in (300, 301):
        jd, td, _, ins = _netbound(seed)
        for scale in (0.01, 0.5):
            z = _z0(0, ins[0].shape, scale)
            tau = np.asarray(jax.jit(lambda s: s * jnp.exp(jnp.log(1 / 8.0)))(
                jnp.max(ins[0])))
            want = np.asarray(grad(jnp.asarray(z), tau,
                                   *map(jnp.asarray, ins), jd))
            got = R.choice_grad(td, torch.from_numpy(z), torch.tensor(tau),
                                *map(torch.from_numpy, ins), True,
                                exp=_jax_fn(jnp.exp), log=_jax_fn(jnp.log))
            _same(got.numpy(), want, f"seed {seed}, z0 x {scale / 0.01:g}")


def test_choice_grad_is_the_scan_model_bit_for_bit():
    """``ref.choice_grad`` (a level at a time, torch) against
    ``choice_grad_xla_order`` (a task at a time, numpy), both with
    ``torch.exp`` / ``torch.log``: at the reference's z0 on netbound seed
    300 and at every 20th step of the plain version's own trajectory."""
    jd, td, _, ins = _netbound(300)
    arrs = tuple(np.asarray(a) for a in (jd.topo, jd.pred, jd.pred_mask,
                                         jd.pred_comm))
    tins = [torch.from_numpy(a) for a in ins]
    z = torch.from_numpy(_z0(0, ins[0].shape))
    mu, nu = torch.zeros_like(z), torch.zeros_like(z)
    scale = tins[0].max()
    a = R.ADAM
    for i, (factor, bc1, bc2) in enumerate(R.schedule(120)):
        tau = scale * factor
        gz = R.choice_grad(td, z, tau, *tins, True)
        if i % 20 == 0:
            want = E.choice_grad_xla_order(
                *arrs, z.numpy(), tau.numpy(), *ins,
                exp=_torch_fn(torch.exp), log=_torch_fn(torch.log))
            _same(gz.numpy(), want, f"step {i}")
        mu = a["b1"] * mu + a["one_b1"] * gz
        nu = a["b2"] * nu + a["one_b2"] * gz * gz
        z = z - a["lr"] * (mu / bc1) / (torch.sqrt(nu / bc2) + a["eps"])


def _reference_x(iters: int, jd=None, ins=None) -> np.ndarray:
    """The reference's best x on netbound seed 300 after ``iters``
    iterations from its own z0."""
    if jd is None:
        jd, _, _, ins = _netbound(300)
    rx, _ = JH._solve_choice(jd, *map(jnp.asarray, ins), iters, 0,
                             use_comm=True)
    return np.asarray(rx, np.float32)


def write_pin(path: Path = PIN) -> None:
    """The reference's best x and λ (``frac_objective`` of x normalised, as
    the spread is measured) on netbound seed 300 at :data:`ITERS`."""
    _, _, prob, _ = _netbound(300)
    pin = {"scenario": "netbound_scenario(seed=300), rigid, comm-aware",
           "z0": "the reference's own (PRNGKey(0), scale 0.01)"}
    for iters in ITERS:
        x = _reference_x(iters)
        pin[str(iters)] = {
            "x": x.tolist(),
            "lam": frac_objective(prob, x.astype(np.float64)
                                  / x.sum(axis=1, keepdims=True))}
    path.write_text(json.dumps(pin, indent=1) + "\n")


@pytest.mark.parametrize("iters", ITERS)
def test_plain_version_lies_within_the_references_spread(iters):
    """C6 closed for the plain version: on netbound seed 300 its λ lies
    within the reference's own one-ulp spread of the reference's, where
    with autograd's gradient it lay 6.1e-5 / 1.1e-4 / 2.9e-4 away, and its
    allocation is the reference's.  The reference's best x is the pin's
    bit for bit."""
    jd, td, prob, ins = _netbound(300)
    rx = _reference_x(iters, jd, ins)
    pinned = json.loads(PIN.read_text())[str(iters)]
    _same(rx, np.asarray(pinned["x"], np.float32), f"the pin at {iters}")
    tx, _ = TH._solve_choice(td, *map(torch.from_numpy, ins), iters, 0,
                             use_comm=True, z0=_z0(0, ins[0].shape))

    def lam(x):
        x = np.asarray(x, np.float64)
        return frac_objective(prob, x / x.sum(axis=1, keepdims=True))
    gap = abs(lam(tx.numpy()) / lam(rx) - 1)
    print(f"{iters} iterations: λ rel to the reference {gap:.3e}")
    assert gap < SPREAD
    np.testing.assert_array_equal(tx.numpy().argmax(1),
                                  np.asarray(rx).argmax(1))


def test_hybrid_solve_keeps_autograds_gradient():
    """The hybrid entry is unchanged: Adam on autograd's gradient of
    ``hybrid_loss``, written out here, gives ``hybrid_solve_ref``'s best x
    and λ bit for bit."""
    for g, m, k in ((TS.default_suite(seed=0)[2].graph, 8, 2),
                    (TW.chameleon("potrf", 6, 512), 64, 8)):
        d = TH.PaddedDag.from_graph(g, "cpu")
        z0 = torch.from_numpy(np.float32(0.01)
                              * TH.reference_normal(0, (g.n,)))
        bx, bv = R.hybrid_solve_ref(d, z0, m=m, k=k, iters=40)
        a = R.ADAM
        z, mu, nu = z0.clone(), torch.zeros(g.n), torch.zeros(g.n)
        scale = torch.maximum(d.pc.max(), d.pg.max())

        def lam(x):
            times = d.pc * x + d.pg * (1.0 - x)
            return torch.maximum(R.hard_longest_path(d, times), torch.maximum(
                torch.dot(d.pc, x) / m, torch.dot(d.pg, 1.0 - x) / k))
        best_x = torch.sigmoid(z)
        best = lam(best_x)
        for factor, bc1, bc2 in R.schedule(40):
            zg = z.detach().requires_grad_(True)
            gz, = torch.autograd.grad(R.hybrid_loss(d, zg, scale * factor,
                                                    m, k), zg)
            with torch.no_grad():
                mu = a["b1"] * mu + a["one_b1"] * gz
                nu = a["b2"] * nu + a["one_b2"] * gz * gz
                z = z - a["lr"] * (mu / bc1) / (torch.sqrt(nu / bc2)
                                                + a["eps"])
                x = torch.sigmoid(z)
                v = lam(x)
                if v < best:
                    best_x, best = x, v
        _same(bx.numpy(), best_x.numpy(), f"n={g.n}")
        assert _bits(bv) == _bits(best)


def _emulation_cases():
    nb = TS.netbound_scenario(seed=300)
    wide = TS.netbound_scenario(width=40, depth=4, seed=3)
    mo = TS.moldable_suite(seed=400, num=1, ccr=2.0)[0]
    return [("netbound s300", nb.graph, nb.counts, True, True),
            ("netbound width 40", wide.graph, (8, 2), True, True),
            ("moldable, comm", mo.graph, mo.machine, True, False),
            ("moldable", mo.graph, mo.machine, False, False)]


def test_sm90_emulation_is_the_plain_gradient_bit_for_bit():
    """The sm90 design of the kernel's emulation, given the plain
    version's exp and log, gives ``ref.choice_grad`` bit for bit, with and
    without the crossing delays, at one and at several warps' width; with
    the delays, so does the scan-by-scan model ``choice_grad_xla_order``
    (the gather design models the hybrid solve only)."""
    for name, g, machine, comm, rigid in _emulation_cases():
        prob, ins = _inputs(g, machine, comm, rigid)
        d = TH.PaddedDag.from_graph(g, "cpu")
        z = np.float32(0.5) * TH.reference_normal(3, ins[0].shape)
        tau = _tau(ins[0], step=10)
        kw = dict(p_choice=ins[0], area=ins[1], type_mask=ins[2],
                  inv_counts=ins[3], use_comm=prob.comm_aware,
                  exp=_torch_fn(torch.exp), log=_torch_fn(torch.log))
        want = R.choice_grad(d, torch.from_numpy(z), torch.tensor(tau),
                             *map(torch.from_numpy, ins),
                             prob.comm_aware).numpy()
        assert np.abs(want).max() > 0, name
        _same(E.gradient_sm90(d, z, tau, **kw), want, f"sm90: {name}")
        if prob.comm_aware:
            _same(E.choice_grad_xla_order(
                *(d.topo.numpy(), d.pred.numpy(), d.pred_mask.numpy(),
                  d.pred_comm.numpy()), z, tau, *ins, exp=kw["exp"],
                log=kw["log"]), want, f"scan model: {name}")


def test_sm90_emulation_solves_as_the_plain_version():
    """Whole solves: the sm90 design's best x and λ equal
    ``choice_solve_ref``'s bit for bit (its λ in XLA's order too)."""
    for name, g, machine, comm, rigid in _emulation_cases()[::2]:
        prob, ins = _inputs(g, machine, comm, rigid)
        d = TH.PaddedDag.from_graph(g, "cpu")
        z0 = np.float32(0.01) * TH.reference_normal(0, ins[0].shape)
        for iters in (0, 1, 15):
            x, v, _ = E.solve(d, z0, iters, R.schedule(iters), design="sm90",
                              p_choice=ins[0], area=ins[1], type_mask=ins[2],
                              inv_counts=ins[3], use_comm=prob.comm_aware,
                              exp=_torch_fn(torch.exp),
                              log=_torch_fn(torch.log))
            px, pv = R.choice_solve_ref(d, torch.from_numpy(z0),
                                        *map(torch.from_numpy, ins),
                                        iters=iters,
                                        use_comm=prob.comm_aware)
            _same(x, px.numpy(), f"{name}, {iters} iterations")
            assert _bits(v) == _bits(pv), (name, iters)


def test_choice_edges_run_in_descending_topological_order():
    """The choice entry's ``pred_edge`` (``PaddedDag.pred_edge_topo``,
    built once with the DAG): the same successor ranges as the DAG's CSR,
    each real slot once, each predecessor's list in descending order of
    its successors' places in ``topo``; ``check_indices`` rejects a list
    out of that order."""
    for g in (TS.netbound_scenario(seed=300).graph,
              TW.chameleon("getrf", 5, 512)):
        d = TH.PaddedDag.from_graph(g, "cpu")
        pe = d.pred_edge_topo.numpy()
        pred, ptr = d.pred.numpy(), d.succ_ptr.numpy()
        pos = np.empty(g.n, np.int64)
        pos[d.topo.numpy()] = np.arange(g.n)
        real = pred >= 0
        assert ((pe >= 0) == real).all()
        assert sorted(pe[real].tolist()) == list(range(int(real.sum())))
        place = {}
        for s, k in zip(*np.nonzero(real)):
            place[int(pe[s, k])] = (int(pred[s, k]), int(s))
        for j in range(g.n):
            succ = [place[e] for e in range(ptr[j], ptr[j + 1])]
            assert all(q == j for q, _ in succ)
            ranks = [pos[s] for _, s in succ]
            assert ranks == sorted(ranks, reverse=True)
        j = int(np.argmax(np.diff(ptr)))
        a, b = [next((s, k) for s, k in zip(*np.nonzero(real))
                     if pe[s, k] == e) for e in (ptr[j], ptr[j] + 1)]
        swapped = pe.copy()
        swapped[a], swapped[b] = pe[b], pe[a]
        with pytest.raises(ValueError, match="pred_edge_topo"):
            HF.check_indices(dataclasses.replace(
                d, pred_edge_topo=torch.from_numpy(swapped)))
