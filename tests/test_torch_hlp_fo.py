"""The port's first-order LP against the JAX package's ``repro.core.hlp_jax``.

``repro_torch.core.hlp_jax`` solves through ``kernels/hlp_fo``, whose plain
version runs here (the kernel, ``csrc/hlp_fo_sm90.cu``, runs on the card:
``tests/test_torch_hlp_fo_card.py``, ``tests/test_torch_hlp_fo_sm90_card.py``).  Held here, on the same inputs
made from seeds with numpy:

* ``reference_normal`` against ``jax.random.normal`` within 3 float32 ulp;
* the plain version's first-step gradient (autograd) against ``jax.grad``
  of the loss built from ``repro.core.hlp_jax.soft_longest_path`` as
  ``_solve`` and ``_solve_choice`` build it, at rtol 1e-5 (atol 1e-6 of
  the gradient's largest entry: the sums run in other orders);
* a numpy emulation of the kernel's hand-written backward
  (``tests/hlp_fo_emulation.py``) against that autograd gradient, at the
  same tolerance;
* whole solves from the reference's own starting logits: best λ at rtol
  1e-5 and identical rounded allocations, on the moldable instances (8
  choices, with and without the crossing delays) the best x bit for bit;
  the emulated kernel's choice gradient bit for bit the plain version's
  in XLA's order; on the ill-conditioned netbound
  seed 300, within the reference's own one-ulp spread (3.6e-5): the choice
  solve's gradient is written out in XLA's order (``ref.choice_grad``),
  which the independent model ``choice_grad_xla_order`` holds to
  ``jax.grad`` bit for bit (ROADMAP C6);
* the reference's own bounds (``tests/test_core_hlp.py``,
  ``tests/test_sim_bounds.py``, ``tests/test_alloc_comm.py``,
  ``tests/test_moldable.py``) run on the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core.dag as JD  # noqa: E402
import repro.core.hlp_jax as JH  # noqa: E402
import repro.core.workloads as JW  # noqa: E402
import repro.sim.scenarios as JS  # noqa: E402
import repro_torch.core.dag as TD  # noqa: E402
import repro_torch.core.hlp_jax as TH  # noqa: E402
import repro_torch.core.workloads as TW  # noqa: E402
import repro_torch.sim.scenarios as TS  # noqa: E402
from repro.core.allocation import AllocationProblem as JAP  # noqa: E402
from repro_torch.core.allocation import frac_objective  # noqa: E402
from repro_torch.core.allocation import AllocationProblem  # noqa: E402
from repro_torch.core.hlp import (canonical_round, solve_hlp,  # noqa: E402
                                  solve_mhlp)
from repro_torch.core.listsched import hlp_ols  # noqa: E402
from repro_torch.kernels.hlp_fo import hlp_fo as HF  # noqa: E402
from repro_torch.kernels.hlp_fo import ref as R  # noqa: E402
from repro_torch.kernels.hlp_fo.xla_math import xla_exp_f32  # noqa: E402
from repro_torch.kernels.hlp_fo.xla_math import xla_log_f32  # noqa: E402
from repro_torch.platform import Platform  # noqa: E402

from hlp_fo_emulation import choice_grad_xla_order  # noqa: E402
from hlp_fo_emulation import gradient as emulated_gradient  # noqa: E402
from hlp_fo_emulation import gradient_sm90 as emulated_sm90  # noqa: E402

RTOL = 1e-5
#: the reference's own λ spread on netbound seed 300 at 300 iterations
#: under one-ulp changes (the largest measured,
#: ``test_references_own_one_ulp_spread_on_netbound``)
SPREAD = 3.6e-5


def _random_pair(seed: int, n: int, p_edge: float = 0.15):
    """One random layered DAG (as ``tests/conftest.py::random_dag``) built
    in both packages."""
    rng = np.random.default_rng(seed)
    edges = [(i, j) for i in range(n) for j in range(i + 1, n)
             if rng.random() < p_edge]
    proc = rng.uniform(0.1, 10.0, size=(n, 2))
    return JD.TaskGraph.build(proc, edges), TD.TaskGraph.build(proc, edges)


def _jax_z0(seed: int, shape) -> np.ndarray:
    return np.asarray(0.01 * jax.random.normal(jax.random.PRNGKey(seed),
                                               shape))


def _twin(fn):
    """A float32 numpy map through one of the plain version's XLA twins."""
    return lambda v: fn(torch.from_numpy(np.array(v, np.float32))).numpy()


def _program_z0(seed: int, shape) -> np.ndarray:
    """The z0 of the reference's jitted solve: XLA folds 0.01 · √2 into
    one constant before the product with erfinv(u), so some entries lie
    an ulp from the eager ``_jax_z0``'s."""
    return np.array(jax.jit(lambda: 0.01 * jax.random.normal(
        jax.random.PRNGKey(seed), shape))(), np.float32)


def _choice_inputs(prob):
    """``_solve_problem``'s float32 device inputs, as numpy."""
    p_dev = np.where(prob.finite, prob.p_choice, 1e12)
    area = p_dev * prob.width_of.astype(np.float64)
    inv = 1.0 / np.asarray(prob.counts, dtype=np.float64)
    return [np.asarray(a, dtype=np.float32)
            for a in (p_dev, area, prob.type_mask, inv)]


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


def test_reference_normal_reproduces_jax_random_normal():
    total = differ = 0
    for seed in (0, 1, 7, 123, 2 ** 31 - 1):
        for shape in ((37,), (43, 2), (4620,), (200, 3)):
            want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                                shape))
            got = TH.reference_normal(seed, shape)
            assert got.dtype == np.float32 and got.shape == shape
            ulp = np.abs(got.view(np.int32).astype(np.int64)
                         - want.view(np.int32).astype(np.int64))
            assert ulp.max() <= 3, (seed, shape)
            total += ulp.size
            differ += int((ulp > 0).sum())
    assert differ <= total // 100, (differ, total)


def test_padded_dag_is_the_reference_and_its_levels_are_topological():
    graphs = [(a.graph, b.graph) for a, b in zip(JS.comm_suite(seed=50),
                                                 TS.comm_suite(seed=50))]
    graphs.append((JW.chameleon("potrf", 6, 512), TW.chameleon("potrf", 6,
                                                                512)))
    for jg, tg in graphs:
        jd = JH.PaddedDag.from_graph(jg)
        td = TH.PaddedDag.from_graph(tg, "cpu")
        for name in ("topo", "pred", "pred_mask", "pc", "pg", "pred_comm"):
            np.testing.assert_array_equal(getattr(td, name).numpy(),
                                          np.asarray(getattr(jd, name)),
                                          err_msg=name)
        HF.check_dag(td)
        HF.check_indices(td)
        order = torch.cat(td.level_slices)
        assert sorted(order.tolist()) == list(range(tg.n))
        assert td.levels == int(tg.level.max()) + 1
        assert td.succ_task.shape[0] == tg.num_edges


def _jax_hybrid_loss(jd, m, k):
    def loss(z, tau):
        x = jax.nn.sigmoid(z)
        times = jd.pc * x + jd.pg * (1.0 - x)
        cp = JH.soft_longest_path(jd, times, tau)
        terms = jnp.stack([cp, jnp.dot(jd.pc, x) / m,
                           jnp.dot(jd.pg, 1.0 - x) / k])
        mx = jnp.max(terms)
        return mx + tau * jnp.log(jnp.sum(jnp.exp((terms - mx) / tau)))
    return loss


def _jax_choice_loss(jd, p, area, tm, inv, use_comm):
    def loss(z, tau):
        x = jax.nn.softmax(z, axis=1)
        delay = None
        if use_comm:
            X = x @ tm.T
            delay = jd.pred_comm * (1.0 - jnp.einsum("npq,nq->np",
                                                     X[jd.pred], X))
        times = (p * x).sum(axis=1)
        cp = JH.soft_longest_path(jd, times, tau, delay)
        loads = (tm @ (area * x).sum(axis=0)) * inv
        terms = jnp.concatenate([jnp.stack([cp]), loads])
        mx = jnp.max(terms)
        return mx + tau * jnp.log(jnp.sum(jnp.exp((terms - mx) / tau)))
    return loss


def _gradient_cases():
    """(name, jax grad, autograd grad, emulated grad) at step 0 and at a
    late step: hybrid, choice, choice with comm."""
    cases = []
    jsc, tsc = JS.default_suite(seed=0)[3], TS.default_suite(seed=0)[3]
    jcm, tcm = JS.comm_suite(seed=50)[2], TS.comm_suite(seed=50)[2]
    jmo, tmo = (JS.moldable_suite(seed=400, num=1, ccr=2.0)[0],
                TS.moldable_suite(seed=400, num=1, ccr=2.0)[0])
    # hybrid
    jd = JH.PaddedDag.from_graph(jsc.graph)
    td = TH.PaddedDag.from_graph(tsc.graph, "cpu")
    scale = torch.maximum(td.pc.max(), td.pg.max())
    for i in (0, 250):
        z = _jax_z0(i, (tsc.graph.n,)) * (1 + 100 * i)
        tau = scale * R.schedule(300)[i, 0]
        jg = np.asarray(jax.grad(_jax_hybrid_loss(jd, 8, 2))(
            jnp.asarray(z), jnp.float32(tau)))
        zt = torch.tensor(z, requires_grad=True)
        tg, = torch.autograd.grad(R.hybrid_loss(td, zt, tau, 8, 2), zt)
        eg = emulated_gradient(td, z, float(tau), m=8, k=2)
        cases.append((f"hybrid step {i}", jg, tg.numpy(), eg, None))
    # choice, with and without comm
    for name, (js, ts), machine, rigid in (
            ("choice+comm rigid", (jcm, tcm), (8, 2), True),
            ("choice+comm moldable", (jmo, tmo), None, False),
            ("choice moldable", (jmo, tmo), None, False)):
        comm = "comm" in name
        jm = js.machine if machine is None else machine
        tmach = ts.machine if machine is None else machine
        jprob = JAP.build(js.graph, jm, comm_aware=comm, rigid=rigid)
        tprob = AllocationProblem.build(ts.graph, tmach, comm_aware=comm,
                                        rigid=rigid)
        ins = _choice_inputs(tprob)
        np.testing.assert_array_equal(ins[0], _choice_inputs(jprob)[0])
        jd = JH.PaddedDag.from_graph(js.graph)
        td = TH.PaddedDag.from_graph(ts.graph, "cpu")
        z = _jax_z0(3, ins[0].shape) * 50
        tau = np.float32(ins[0].max() * R.schedule(300)[10, 0].item())
        jg = np.asarray(jax.grad(_jax_choice_loss(
            jd, *[jnp.asarray(a) for a in ins], comm))(jnp.asarray(z),
                                                        jnp.float32(tau)))
        zt = torch.tensor(z, requires_grad=True)
        tg, = torch.autograd.grad(R.choice_loss(
            td, zt, torch.tensor(tau), *[torch.tensor(a) for a in ins],
            comm), zt)
        eg = emulated_sm90(td, z, tau, p_choice=ins[0], area=ins[1],
                           type_mask=ins[2], inv_counts=ins[3],
                           use_comm=comm, exp=_twin(xla_exp_f32),
                           log=_twin(xla_log_f32))
        xg = R.choice_grad(td, torch.tensor(z), torch.tensor(tau),
                           *[torch.tensor(a) for a in ins], comm)
        cases.append((name, jg, tg.numpy(), eg, xg.numpy()))
    return cases


def test_plain_gradient_matches_jax_grad_and_the_emulated_kernel():
    """Autograd's gradient against ``jax.grad`` and the emulated kernel's
    against autograd's, at rtol 1e-5 (other sum orders); on the choice
    grids (the moldable instance with and without the crossing delays
    among them) the emulated kernel also equals the plain version's
    gradient in XLA's order, ``ref.choice_grad``, bit for bit."""
    for name, jg, tg, eg, xg in _gradient_cases():
        assert np.abs(jg).max() > 0, name
        _close(tg, jg, f"autograd vs jax.grad: {name}")
        _close(eg, tg, f"emulated kernel vs autograd: {name}")
        if xg is not None:
            np.testing.assert_array_equal(
                np.asarray(eg, np.float32).view(np.int32),
                np.asarray(xg, np.float32).view(np.int32), err_msg=name)


def test_hybrid_solve_from_the_reference_z0_matches_it():
    cases = [(a.graph, b.graph, 8, 2) for a, b in zip(JS.default_suite(seed=0),
                                                      TS.default_suite(seed=0))]
    cases.append((JW.chameleon("potrf", 10, 512),
                  TW.chameleon("potrf", 10, 512), 64, 8))
    for jg, tg, m, k in cases:
        jx, jv = JH._solve(JH.PaddedDag.from_graph(jg), m, k, 300, 0)
        z0 = _jax_z0(0, (jg.n,))
        tx, tv = TH._solve(TH.PaddedDag.from_graph(tg, "cpu"), m, k, 300, 0,
                           z0=z0)
        assert float(tv) == pytest.approx(float(jv), rel=RTOL), tg.n
        np.testing.assert_array_equal(tx.numpy() >= 0.5,
                                      np.asarray(jx) >= 0.5)


def test_choice_solve_from_the_reference_z0_matches_it():
    """Whole choice solves, 200 iterations, from the z0 of the reference's
    own program: on comm_suite's rigid grids λ at rtol 1e-5 and the
    allocation; on both moldable instances (20 tasks, 8 choices), with and
    without the crossing delays, the reference's best x and λ bit for bit
    (ROADMAP C6, closed)."""
    cases = [(a.graph, b.graph, (8, 2), True, True)
             for a, b in zip(JS.comm_suite(seed=50)[:3],
                             TS.comm_suite(seed=50)[:3])]
    for a, b in zip(JS.moldable_suite(seed=400, num=2, ccr=2.0),
                    TS.moldable_suite(seed=400, num=2, ccr=2.0)):
        cases += [(a.graph, b.graph, b.machine, False, comm)
                  for comm in (True, False)]
    for jg, tg, machine, rigid, comm in cases:
        prob = AllocationProblem.build(tg, machine, comm_aware=comm,
                                       rigid=rigid)
        ins = _choice_inputs(prob)
        z0 = _program_z0(0, ins[0].shape)
        jx, jv = JH._solve_choice(JH.PaddedDag.from_graph(jg),
                                  *[jnp.asarray(a) for a in ins], 200, 0,
                                  use_comm=prob.comm_aware)
        tx, tv = TH._solve_choice(TH.PaddedDag.from_graph(tg, "cpu"),
                                  *[torch.tensor(a) for a in ins], 200, 0,
                                  use_comm=prob.comm_aware, z0=z0)
        if not rigid:
            np.testing.assert_array_equal(
                tx.numpy().view(np.int32),
                np.asarray(jx, np.float32).view(np.int32))
            assert float(tv) == float(jv)
        assert float(tv) == pytest.approx(float(jv), rel=RTOL), tg.n
        np.testing.assert_array_equal(tx.numpy().argmax(1),
                                      np.asarray(jx).argmax(1))


def _netbound_s300():
    """Netbound seed 300's comm-aware rigid grid as float32 numpy inputs,
    the reference's PaddedDag and the port's."""
    a = JS.netbound_scenario(seed=300)
    b = TS.netbound_scenario(seed=300)
    prob = AllocationProblem.build(b.graph, b.counts, comm_aware=True,
                                   rigid=True)
    return (_choice_inputs(prob), JH.PaddedDag.from_graph(a.graph),
            TH.PaddedDag.from_graph(b.graph, "cpu"), prob)


def test_ill_conditioned_netbound_instance_keeps_the_references_allocation():
    """On netbound seed 300 (the campaign network sub-grid's first
    instance, comm-aware, ill-conditioned) the plain version's λ lies
    within the reference's own one-ulp spread of the reference's, and its
    allocation is the reference's.  Before its gradient was written in
    XLA's order the gap was 2.9e-4 (ROADMAP C6, the tests below)."""
    a = JS.netbound_scenario(seed=300)
    b = TS.netbound_scenario(seed=300)
    ja = JH.solve_hlp_jax(a.graph, *a.counts, iters=300, comm_aware=True)
    ta = TH.solve_hlp_jax(b.graph, *b.counts, iters=300, comm_aware=True,
                          device="cpu")
    rel = abs(ta.lp_value / ja.lp_value - 1)
    print(f"netbound seed 300: λ rel {rel:.3e}")
    assert rel < SPREAD
    np.testing.assert_array_equal(ta.alloc, ja.alloc)


def test_netbound_first_difference_is_the_softmax_exp():
    """C6, step 1 of ``_solve_choice`` on netbound seed 300 from the
    reference's z0, each piece of the loss fed the same float32 inputs in
    both packages.  The first value that differs is x = softmax(z0) at one
    entry, and the op that makes it is exp: ``jnp.exp`` (XLA:CPU's own
    polynomial) and ``torch.exp`` round the same input differently, and no
    reordering reproduces a transcendental's bits.  The other pieces that
    differ at step 1 are contractions: XLA fuses each multiply-add of the
    task times and of the crossing dot into one FMA (one rounding), where
    the plain version rounds twice."""
    (p, area, tm, inv), jd, td, _ = _netbound_s300()
    z0 = _jax_z0(0, p.shape)
    jx = np.asarray(jax.jit(lambda z: jax.nn.softmax(z, axis=1))(z0))
    tx = R._softmax(torch.tensor(z0), torch.exp).numpy()
    first = np.argwhere(jx != tx)
    assert len(first) >= 1
    # XLA's own exp (the plain version's default since) closes that gap
    np.testing.assert_array_equal(R._softmax(torch.tensor(z0)).numpy(), jx)
    arg = (z0 - z0.max(axis=1, keepdims=True)).astype(np.float32)
    je = np.asarray(jax.jit(jnp.exp)(arg))
    te = torch.exp(torch.tensor(arg)).numpy()
    # every row whose x differs has an exp that differs on the same input
    assert {int(i) for i in first[:, 0]} <= {int(i) for i in
                                              np.argwhere(je != te)[:, 0]}
    for i, c in first:
        print(f"x[{i}, {c}]: exp({arg[i, c]!r}) = {je[i, c]!r} (jnp.exp), "
              f"{te[i, c]!r} (torch.exp); x {jx[i, c]!r} vs {tx[i, c]!r}")
    # on the reference's x: its task times and crossings are the FMA forms
    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(np.float32)
    jt = np.asarray(jax.jit(lambda x: (p * x).sum(axis=1))(jx))
    tt = (torch.tensor(p) * torch.tensor(jx)).sum(dim=1).numpy()
    np.testing.assert_array_equal(
        jt, fma(p[:, 1], jx[:, 1], (p[:, 0] * jx[:, 0]).astype(np.float32)))
    X = jx @ tm.T
    jc = np.asarray(jax.jit(lambda X: 1.0 - jnp.einsum(
        "npq,nq->np", X[jd.pred], X))(X))
    A, B = X[np.maximum(td.pred.numpy(), 0)], X[:, None, :]
    real = td.pred_mask.numpy()
    np.testing.assert_array_equal(
        jc[real], (1 - fma(A[..., 1], B[..., 1],
                           (A[..., 0] * B[..., 0]).astype(np.float32)))[real])
    print(f"task times differing from the plain version's: "
          f"{int((jt != tt).sum())} of {jt.size}")


def _netbound_args():
    """``choice_grad_xla_order``'s DAG arrays for netbound seed 300."""
    _, jd, _, _ = _netbound_s300()
    return tuple(np.asarray(a) for a in (jd.topo, jd.pred, jd.pred_mask,
                                         jd.pred_comm))


def _torch_fn(fn):
    def apply(v):
        return fn(torch.tensor(np.asarray(v, np.float32))).numpy()
    return apply


def _solve_with_xla_backward(iters: int) -> np.ndarray:
    """The plain version's solve of netbound seed 300 from the reference's
    z0 (its forward: ``torch.exp`` and ``torch.log``; its schedule, Adam
    and best-iterate rule) with autograd's gradient replaced by
    :func:`choice_grad_xla_order`; the best x."""
    (p, area, tm, inv), _, td, _ = _netbound_s300()
    tins = [torch.tensor(a) for a in (p, area, tm, inv)]
    arrs = _netbound_args()
    a = R.ADAM
    z = torch.tensor(_jax_z0(0, p.shape))
    mu, nu = torch.zeros_like(z), torch.zeros_like(z)
    scale = torch.where(torch.isfinite(tins[0]), tins[0], 0.0).max()

    def lam(x):
        times, loads, delay = R._choice_terms(td, x, *tins, True)
        return torch.maximum(R.hard_longest_path(td, times, delay),
                             loads.max())
    best_x = R._softmax(z, torch.exp)
    best_val = lam(best_x)
    for factor, bc1, bc2 in R.schedule(iters):
        tau = scale * factor
        gz = torch.tensor(choice_grad_xla_order(
            *arrs, z.numpy(), tau.numpy(), p, area, tm, inv,
            exp=_torch_fn(torch.exp), log=_torch_fn(torch.log)))
        mu = a["b1"] * mu + a["one_b1"] * gz
        nu = a["b2"] * nu + a["one_b2"] * gz * gz
        z = z - a["lr"] * (mu / bc1) / (torch.sqrt(nu / bc2) + a["eps"])
        x = R._softmax(z, torch.exp)
        val = lam(x)
        if val < best_val:
            best_x, best_val = x, val
    return best_x.numpy()


def test_hand_written_backward_in_xlas_order_is_jax_grad_bit_for_bit():
    """C6: ``choice_grad_xla_order`` (``tests/hlp_fo_emulation.py``), the
    backward of ``_solve_choice``'s loss written out in the order and with
    the contractions of the program XLA:CPU compiles for
    ``jax.jit(jax.grad(loss))`` (its inputs traced arguments, as in
    ``_solve_choice``), equals that gradient bit for bit at step 1 on
    netbound seed 300 from the reference's z0, given XLA's own ``exp`` and
    ``log``.  Then a solve with that gradient (``torch.exp`` /
    ``torch.log``) and the plain version, whose gradient
    (``ref.choice_grad``) is written in the same order, both land within
    the reference's one-ulp spread of the reference's λ at 160, 250 and
    300 iterations, allocations identical, where the plain version with
    autograd's gradient was 6.1e-5 / 1.1e-4 / 2.9e-4 away: the backward's
    rounding order is what parted the two trajectories (ROADMAP C6)."""
    (p, area, tm, inv), jd, td, prob = _netbound_s300()
    z0 = _jax_z0(0, p.shape)

    def loss(z, tau, p, area, tm, inv, d):
        x = jax.nn.softmax(z, axis=1)
        X = x @ tm.T
        delay = d.pred_comm * (1.0 - jnp.einsum("npq,nq->np", X[d.pred], X))
        cp = JH.soft_longest_path(d, (p * x).sum(axis=1), tau, delay)
        loads = (tm @ (area * x).sum(axis=0)) * inv
        terms = jnp.concatenate([jnp.stack([cp]), loads])
        mx = jnp.max(terms)
        return mx + tau * jnp.log(jnp.sum(jnp.exp((terms - mx) / tau)))
    scale = jnp.max(jnp.where(jnp.isfinite(p), p, 0.0))
    tau = jax.jit(lambda s: s * jnp.exp(jnp.log(1 / 8.0)))(scale)
    want = np.asarray(jax.jit(jax.grad(loss))(
        jnp.asarray(z0), tau, *map(jnp.asarray, (p, area, tm, inv)), jd))
    got = choice_grad_xla_order(
        *_netbound_args(), z0, np.asarray(tau), p, area, tm, inv,
        exp=jax.jit(jnp.exp), log=jax.jit(jnp.log))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ins = [jnp.asarray(a) for a in (p, area, tm, inv)]
    tins = [torch.tensor(a) for a in (p, area, tm, inv)]

    def lam(x):
        x = np.asarray(x, np.float64)
        return frac_objective(prob, x / x.sum(axis=1, keepdims=True))
    for iters in (160, 250, 300):
        rx, _ = JH._solve_choice(jd, *ins, iters, 0, use_comm=True)
        tx, _ = TH._solve_choice(td, *tins, iters, 0, use_comm=True, z0=z0)
        hx = _solve_with_xla_backward(iters)
        base = lam(rx)
        gap, plain = abs(lam(hx) / base - 1), abs(lam(tx.numpy()) / base - 1)
        print(f"{iters} iterations: λ rel to the reference, XLA-order "
              f"backward {gap:.3e}, the plain version {plain:.3e}")
        assert gap < SPREAD and plain < SPREAD
        np.testing.assert_array_equal(hx.argmax(1), np.asarray(rx).argmax(1))
        np.testing.assert_array_equal(tx.numpy().argmax(1),
                                      np.asarray(rx).argmax(1))


def _jax_solve_choice_from(d, p_choice, area, type_mask, inv_counts, z0,
                           iters, exp):
    """``repro.core.hlp_jax._solve_choice`` with use_comm, written out from
    given logits ``z0``; ``exp`` stands in for ``jnp.exp`` in the soft
    longest path and its smooth max."""
    def soft_longest_path(times, tau, delay):
        def step(finish, j):
            pf = jnp.where(d.pred_mask[j], finish[d.pred[j]] + delay[j],
                           -1e30)
            m = jnp.max(pf)
            soft = m + tau * jnp.log(jnp.sum(exp((pf - m) / tau)) + 1e-30) \
                * 1.0
            start = jnp.where(jnp.any(d.pred_mask[j]),
                              jnp.maximum(soft, 0.0), 0.0)
            return finish.at[j].set(start + times[j]), ()
        finish, _ = jax.lax.scan(step, jnp.zeros(times.shape[0]), d.topo)
        m = jnp.max(finish)
        return m + tau * jnp.log(jnp.sum(exp((finish - m) / tau)) + 1e-30)

    def delays(x):
        X = x @ type_mask.T
        return d.pred_comm * (1.0 - jnp.einsum("npq,nq->np", X[d.pred], X))

    def loads(x):
        return (type_mask @ (area * x).sum(axis=0)) * inv_counts

    def lam_exact(x):
        cp = JH.hard_longest_path(d, (p_choice * x).sum(axis=1), delays(x))
        return jnp.maximum(cp, jnp.max(loads(x)))

    def loss(z, tau):
        x = jax.nn.softmax(z, axis=1)
        cp = soft_longest_path((p_choice * x).sum(axis=1), tau, delays(x))
        terms = jnp.concatenate([jnp.stack([cp]), loads(x)])
        mx = jnp.max(terms)
        return mx + tau * jnp.log(jnp.sum(jnp.exp((terms - mx) / tau)))

    grad = jax.grad(loss)
    scale = jnp.max(jnp.where(jnp.isfinite(p_choice), p_choice, 0.0))
    lr, b1, b2, eps = 0.25, 0.9, 0.999, 1e-8

    def body(carry, i):
        z, mu, nu, best_x, best_val = carry
        frac = i.astype(jnp.float32) / max(iters - 1, 1)
        tau = scale * jnp.exp(jnp.log(1 / 8.0) * (1 - frac)
                              + jnp.log(1 / 512.0) * frac)
        gz = grad(z, tau)
        mu = b1 * mu + (1 - b1) * gz
        nu = b2 * nu + (1 - b2) * gz * gz
        mh = mu / (1 - b1 ** (i + 1))
        nh = nu / (1 - b2 ** (i + 1))
        z = z - lr * mh / (jnp.sqrt(nh) + eps)
        x = jax.nn.softmax(z, axis=1)
        val = lam_exact(x)
        better = val < best_val
        return (z, mu, nu, jnp.where(better, x, best_x),
                jnp.where(better, val, best_val)), ()

    x0 = jax.nn.softmax(z0, axis=1)
    init = (z0, jnp.zeros_like(z0), jnp.zeros_like(z0), x0, lam_exact(x0))
    (_, _, _, best_x, best_val), _ = jax.lax.scan(
        body, init, jnp.arange(iters, dtype=jnp.int32))
    return best_x, best_val


def _ulp_exp(salt):
    """``jnp.exp`` moved by one ulp, up or down, on half of its inputs
    (chosen by a hash of the input's bits and ``salt``); its derivative is
    exp's own."""
    def exp(v):
        e = jnp.exp(v)
        h = (jax.lax.bitcast_convert_type(v, jnp.uint32)
             * jnp.uint32(2654435761) + jnp.uint32(salt)) \
            * jnp.uint32(2246822519)
        es = jax.lax.stop_gradient(e)
        moved = jnp.where((h >> 20) & 1 == 1, jnp.nextafter(es, jnp.inf),
                          jnp.nextafter(es, -jnp.inf))
        return e + jnp.where((h >> 28) < 8, moved - es, 0.0)
    return exp


def test_references_own_one_ulp_spread_on_netbound():
    """C6: the reference's own λ spread on netbound seed 300 at 300
    iterations, against the port's gap.  ``_solve_choice`` written out
    from given logits reproduces the reference bit for bit from its z0;
    then it runs from z0 with one entry nudged by one ulp (four entries),
    and with half of its soft-path exps moved by one ulp (three draws).
    Held against the plain version's gap, which lies under every spread
    but the smallest: its gradient is written in XLA's order
    (``ref.choice_grad``).  With autograd's gradient it lay 8x above the
    largest (2.9e-4): the transcendentals alone did not explain that gap,
    the backward's rounding order did (ROADMAP C6).  A solve with the
    independent model ``choice_grad_xla_order`` lies within the spread
    too.  Also printed: both float32 solves' distance
    from the same solve in float64 (the copy under ``jax.enable_x64``) at
    250 and 300 iterations."""
    (p, area, tm, inv), jd, td, prob = _netbound_s300()
    ins = [jnp.asarray(a) for a in (p, area, tm, inv)]
    z0 = _jax_z0(0, p.shape)
    solve = jax.jit(_jax_solve_choice_from, static_argnames=("iters", "exp"))
    rx, rv = JH._solve_choice(jd, *ins, 300, 0, use_comm=True)
    cx, cv = solve(jd, *ins, jnp.asarray(z0), iters=300, exp=jnp.exp)
    np.testing.assert_array_equal(np.asarray(cx), np.asarray(rx))
    assert float(cv) == float(rv)

    def lam(x):
        x = np.asarray(x, np.float64)
        return frac_objective(prob, x / x.sum(axis=1, keepdims=True))
    base = lam(rx)
    spreads = {}
    for i, c in ((15, 0), (0, 1), (31, 0), (59, 1)):
        zn = z0.copy()
        zn[i, c] = np.nextafter(zn[i, c], np.float32(np.inf))
        x, _ = solve(jd, *ins, jnp.asarray(zn), iters=300, exp=jnp.exp)
        spreads[f"z0[{i}, {c}] + 1 ulp"] = abs(lam(x) / base - 1)
        np.testing.assert_array_equal(np.asarray(x).argmax(1),
                                      np.asarray(rx).argmax(1))
    for salt in (0, 7919, 15838):
        x, _ = solve(jd, *ins, jnp.asarray(z0), iters=300,
                     exp=_ulp_exp(salt))
        spreads[f"exp ± 1 ulp, draw {salt}"] = abs(lam(x) / base - 1)
    tins = [torch.tensor(a) for a in (p, area, tm, inv)]
    tx, _ = TH._solve_choice(td, *tins, 300, 0, use_comm=True, z0=z0)
    gap = abs(lam(tx.numpy()) / base - 1)
    for what, v in spreads.items():
        print(f"reference, {what}: λ rel {v:.3e}")
        assert v < 1e-3, what
    print(f"plain version: λ rel {gap:.3e}")
    assert gap < max(spreads.values()) <= SPREAD
    reordered = abs(lam(_solve_with_xla_backward(300)) / base - 1)
    print(f"plain version, backward in XLA's order: λ rel {reordered:.3e}")
    assert reordered < max(spreads.values())
    with jax.enable_x64(True):
        d64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)
                                  if np.asarray(a).dtype.kind == "f" else a),
            jd)
        ins64 = [jnp.asarray(a, jnp.float64) for a in (p, area, tm, inv)]
        for iters in (250, 300):
            x64, _ = solve(d64, *ins64, jnp.asarray(z0, jnp.float64),
                           iters=iters, exp=jnp.exp)
            exact = lam(np.asarray(x64))
            rx, _ = JH._solve_choice(jd, *ins, iters, 0, use_comm=True)
            tx, _ = TH._solve_choice(td, *tins, iters, 0, use_comm=True,
                                     z0=z0)
            ref, port = lam(rx), lam(tx.numpy())
            assert np.isfinite([exact, ref, port]).all()
            print(f"{iters} iterations: λ rel to the float64 solve, "
                  f"reference {abs(ref / exact - 1):.3e}, plain version "
                  f"{abs(port / exact - 1):.3e}")


def test_public_solvers_with_their_own_draw_match_the_reference():
    for a, b in zip(JS.default_suite(seed=0), TS.default_suite(seed=0)):
        ja = JH.solve_hlp_jax(a.graph, 8, 2, iters=300)
        ta = TH.solve_hlp_jax(b.graph, 8, 2, iters=300, device="cpu")
        assert ta.lp_value == pytest.approx(ja.lp_value, rel=RTOL)
        np.testing.assert_array_equal(ta.alloc, ja.alloc)
        assert ta.status == "first-order"
    a = JS.moldable_suite(seed=200, num=1)[0]
    b = TS.moldable_suite(seed=200, num=1)[0]
    ja = JH.solve_mhlp_jax(a.graph, a.machine, iters=200)
    ta = TH.solve_mhlp_jax(b.graph, b.machine, iters=200, device="cpu")
    assert ta.lp_value == pytest.approx(ja.lp_value, rel=RTOL)
    np.testing.assert_array_equal(ta.alloc, ja.alloc)
    np.testing.assert_array_equal(ta.width, ja.width)


def test_first_order_lp_within_three_percent_of_highs():
    """``tests/test_core_hlp.py::test_jax_solver_near_optimal`` on the port."""
    for seed in (1, 12, 345, 6789):
        _, g = _random_pair(seed, 15)
        exact = solve_hlp(g, 4, 2)
        approx = TH.solve_hlp_jax(g, 4, 2, iters=300, device="cpu")
        assert approx.lp_value >= exact.lp_value - 1e-9
        assert approx.lp_value <= exact.lp_value * 1.03


def test_first_order_lp_within_one_percent_and_canonical_rounding_agrees():
    """``tests/test_sim_bounds.py``'s two first-order tests on the port."""
    for seed in (0, 3, 7):
        _, g = _random_pair(seed, 14)
        m, k = 4, 2
        exact = solve_hlp(g, m, k)
        approx = TH.solve_hlp_jax(g, m, k, iters=400, seed=0, device="cpu")
        assert approx.lp_value >= exact.lp_value - 1e-9
        assert approx.lp_value <= exact.lp_value * 1.01
        ms_exact = hlp_ols(g, [m, k], exact.alloc).makespan
        ms_fo = hlp_ols(g, [m, k], approx.alloc).makespan
        assert ms_fo == pytest.approx(ms_exact, rel=0.25)
        np.testing.assert_array_equal(approx.alloc, approx.x_frac < 0.5)
        exact_c = solve_hlp(g, m, k, canonical=True)
        approx_c = TH.solve_hlp_jax(g, m, k, iters=400, seed=0,
                                    canonical=True, device="cpu")
        np.testing.assert_array_equal(exact_c.alloc, approx_c.alloc)
        np.testing.assert_array_equal(
            exact_c.alloc, canonical_round(g, m, k, exact_c.x_frac))


def test_comm_aware_and_moldable_first_order_solvers_bound_highs():
    """``tests/test_alloc_comm.py::test_jax_solvers_consume_the_same_problem``
    on the port."""
    sc = TS.netbound_scenario(counts=(8, 2), seed=1)
    g = sc.graph
    exact = solve_hlp(g, 8, 2, comm_aware=True)
    approx = TH.solve_hlp_jax(g, 8, 2, comm_aware=True, iters=300,
                              device="cpu")
    assert approx.lp_value >= exact.lp_value - 1e-6
    assert approx.lp_value <= exact.lp_value * 1.10
    assert approx.x_frac.shape == (g.n,)
    scm = TS.moldable_cholesky_scenario(seed=1, ccr=0.8)
    em = solve_mhlp(scm.graph, scm.machine, comm_aware=True)
    am = TH.solve_mhlp_jax(scm.graph, scm.machine, comm_aware=True, iters=250,
                           device="cpu")
    assert am.lp_value >= em.lp_value - 1e-6
    hlp_ols(scm.graph, scm.machine, am.alloc, am.width).validate(
        scm.graph, scm.machine)


def test_mhlp_objective_finite_with_type_restricted_tasks():
    """``tests/test_moldable.py``'s regression on the port: an infinite
    choice is priced at 1e12 and λ stays finite."""
    proc = np.array([[4.0, 1.0], [3.0, np.inf], [4.0, 1.0]])
    curve = np.tile([1.0, 1.8], (3, 1))
    g = TD.TaskGraph.build(proc, [(0, 1), (1, 2)], speedup=curve)
    p = Platform.hybrid(2, 2)
    exact = solve_mhlp(g, p)
    approx = TH.solve_mhlp_jax(g, p, iters=200, device="cpu")
    assert np.isfinite(exact.lp_value) and np.isfinite(approx.lp_value)
    assert approx.lp_value >= exact.lp_value - 1e-9
    assert approx.alloc[1] == 0


def test_wrapper_takes_the_plain_version_on_the_cpu_and_checks_inputs():
    g = TW.chameleon("potrf", 4, 512)
    d = TH.PaddedDag.from_graph(g, "cpu")
    z0 = torch.zeros(g.n)
    HF.reset_launch_count()
    x, v = HF.hybrid(d, z0, m=4, k=2, iters=3)
    assert x.shape == (g.n,) and x.dtype == torch.float32 and v.dim() == 0
    assert HF.launch_count() == 0
    with pytest.raises(ValueError, match="z0"):
        HF.hybrid(d, torch.zeros(g.n + 1), m=4, k=2, iters=3)
    with pytest.raises(ValueError, match="m, k"):
        HF.hybrid(d, z0, m=0, k=2, iters=3)
    import dataclasses
    bad = dataclasses.replace(d, pred=d.pred.long())
    with pytest.raises(TypeError, match="pred"):
        HF.hybrid(bad, z0, m=4, k=2, iters=3)
    swapped = d.level_task.clone()
    swapped[[0, -1]] = swapped[[-1, 0]]
    with pytest.raises(ValueError, match="topological"):
        HF.hybrid(dataclasses.replace(d, level_task=swapped), z0, m=4, k=2,
                  iters=3)
    slot = d.succ_slot.clone()
    slot[0] = d.pred.shape[1]
    with pytest.raises(ValueError, match="successor"):
        HF.hybrid(dataclasses.replace(d, succ_slot=slot), z0, m=4, k=2,
                  iters=3)
    # a layout past 227 KB: the kernel moves its per-task arrays to a
    # scratch buffer
    big = TH.PaddedDag.from_graph(TW.chameleon("potri", 20, 512), "cpu")
    assert HF._check_size(big, 1, 0, False) == 0
    assert HF._check_size(big, 8, 2, True) > 0
    edge = d.pred_edge.clone()
    edge[d.pred_edge == 0] = 1
    with pytest.raises(ValueError, match="pred_edge"):
        HF.hybrid(dataclasses.replace(d, pred_edge=edge), z0, m=4, k=2,
                  iters=3)
    assert HF.threads_for(1) == 32 and HF.threads_for(210) == 224
    assert HF.threads_for(5000) == HF.MAX_THREADS


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = TS.default_suite(seed=0)[0]
    with pytest.raises(RuntimeError, match="cuda"):
        TH.solve_hlp_jax(sc.graph, 8, 2, iters=2)
    with pytest.raises(RuntimeError, match="cuda"):
        TH.solve_mhlp_jax(sc.graph, sc.machine, iters=2)
    with pytest.raises(RuntimeError, match="cuda"):
        TH.PaddedDag.from_graph(sc.graph)
