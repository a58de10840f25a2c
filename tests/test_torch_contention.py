"""The port's contention pricing against the JAX package's, in float64.

``repro_torch.sim.batch``'s whole-bucket contention fixpoint on the CPU
(the plain versions in ``kernels/contention/ref.py``) is held against the
reference's jitted fixpoint ``repro.sim.batch.contended_bucket_delays`` at
rtol 1e-12 and against the per-plan numpy oracle ``contended_plan_delays``
at rtol 1e-6, atol 1e-9, on the campaign's netbound scenarios
(``benchmarks/campaign.py``'s network sub-grid: seeds 300-302, HLP-OLS and
the contention-aware CAHLP).  The reference runs its fixpoint under
``jax.experimental.enable_x64``, which jax 0.9 no longer has; the tests
hand it ``jax.enable_x64(True)`` in its place through ``monkeypatch``, and
nothing in ``src/repro`` changes.  The CUDA kernel runs only on the card
(``tests/test_torch_contention_card.py``); here its loop is emulated in
numpy (``tests/contention_emulation.py``) and held to the plain version
bit for bit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import repro.sim as J  # noqa: E402
import repro.sim.batch as JB  # noqa: E402
import repro.sim.network as JN  # noqa: E402
import repro.sim.scenarios as JS  # noqa: E402
import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.batch as TB  # noqa: E402
import repro_torch.sim.network as TN  # noqa: E402
import repro_torch.sim.scenarios as TS  # noqa: E402
from repro.sim.adapters import CommAwareHLPScheduler as JCAHLP  # noqa: E402
from repro_torch.kernels.contention import contention as C  # noqa: E402
from repro_torch.sim.adapters import CommAwareHLPScheduler as TCAHLP  # noqa: E402

from contention_emulation import (emulate, fluid_bucket,  # noqa: E402
                                  random_bucket, random_transfer_sets)

CPU = "cpu"
LINKS = [("up", 0), ("down", 0), ("up", 1), ("down", 1), ("up", 2),
         ("down", 2)]


@pytest.fixture
def x64(monkeypatch):
    """The reference's fixpoint with ``jax.enable_x64(True)`` standing for
    the ``jax.experimental.enable_x64`` it imports."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


@pytest.fixture
def default_route():
    """Each test starts and ends on the port's default route."""
    T.set_contention_kernel("torch")
    yield
    T.set_contention_kernel("torch")


def _netbound(n_scen=3, width=12, depth=5):
    """(reference items, port items, networks of each): the campaign's
    netbound sub-grid, each scenario under HLP-OLS and contention-aware
    CAHLP, planned by each package."""
    jitems, titems = [], []
    for i in range(n_scen):
        js = JS.netbound_scenario(width=width, depth=depth, seed=300 + i)
        ts = TS.netbound_scenario(width=width, depth=depth, seed=300 + i)
        for jm, tm in ((lambda: J.make_scheduler("hlp_ols"),
                        lambda: T.make_scheduler("hlp_ols")),
                       (lambda: JCAHLP(contention=True),
                        lambda: TCAHLP(contention=True))):
            jitems.append((js.graph, jm().allocate(js.graph, js.machine)))
            titems.append((ts.graph, tm().allocate(ts.graph, ts.machine)))
    jnets = [J.make_network("maxmin_fair")] * len(jitems)
    tnets = [T.make_network("maxmin_fair")] * len(titems)
    return jitems, titems, jnets, tnets


def _oracle(items, nets):
    return [TN.contended_plan_delays(g, p, T.plan_times(g, p, g.proc), net)
            for (g, p), net in zip(items, nets)]


# ---------------------------------------------------------- fluid solve
def test_fluid_finishes_ref_matches_oracle_and_reference_kernel():
    """The eight random transfer sets of ``tests/test_network_kernel.py``
    and sixteen more over three types' six links (the links of
    ``tests/test_network_properties.py``), one at a time, then the first
    eight in one padded batch."""
    cases = random_transfer_sets()
    for cap, starts, sizes, up, dn in cases + random_transfer_sets(
            16, types=3, first_seed=100):
        links = [(LINKS[u], LINKS[d]) for u, d in zip(up, dn)]
        want = JN._fluid_finishes(starts, sizes, links, cap)
        got = TN.fluid_finishes_ref(
            torch.from_numpy(starts)[None], torch.from_numpy(sizes)[None],
            torch.from_numpy(up)[None], torch.from_numpy(dn)[None],
            torch.ones((1, len(starts)), dtype=torch.bool),
            torch.tensor([cap], dtype=torch.float64), 6)[0].numpy()
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
        with jax.enable_x64(True):
            ref = np.asarray(JN.fluid_finishes_jax(
                jnp.asarray(starts), jnp.asarray(sizes), jnp.asarray(up),
                jnp.asarray(dn), jnp.ones(len(starts), bool), cap, 6))
        assert ref.dtype == np.float64
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)

    Tm = max(len(c[1]) for c in cases)
    batch = np.zeros((4, len(cases), Tm))
    mask = np.zeros((len(cases), Tm), dtype=bool)
    for b, (_, *arrays) in enumerate(cases):
        batch[:, b, :len(arrays[0])] = arrays
        mask[b, :len(arrays[0])] = True
    starts, sizes, up, dn = (torch.from_numpy(a) for a in batch)
    got = TN.fluid_finishes_ref(
        starts, sizes, up.long(), dn.long(), torch.from_numpy(mask),
        torch.tensor([c[0] for c in cases], dtype=torch.float64),
        len(LINKS)).numpy()
    for b, (cap, s, z, u, d) in enumerate(cases):
        one = TN.fluid_finishes_ref(
            torch.from_numpy(s)[None], torch.from_numpy(z)[None],
            torch.from_numpy(u)[None], torch.from_numpy(d)[None],
            torch.ones((1, len(s)), dtype=torch.bool),
            torch.tensor([cap], dtype=torch.float64), len(LINKS))[0].numpy()
        np.testing.assert_array_equal(got[b, :len(s)], one)
        assert not got[b, len(s):].any()


# ------------------------------------------------------- whole-bucket path
def test_contended_durations_match_reference_fixpoint_and_oracle(x64):
    """Three campaign netbound scenarios x (HLP-OLS, CAHLP): the plain
    fixpoint on the reference's own bucket arrays against its jitted
    ``_contended_durations`` at rtol 1e-12, and the port's per-edge delays
    against the reference's at rtol 1e-12 and the oracle's at 1e-6."""
    jitems, titems, jnets, tnets = _netbound()
    _, groups = TB.contended_buckets(titems, tnets)
    assert groups
    for (n_pad, P_pad, L), (idxs, _, cb) in groups.items():
        got = C.contended_durations(*cb.tensors(), num_links=L,
                                    iters=TN.CONTENTION_ITERS)
        assert got.dtype == torch.float64
        with jax.enable_x64(True):
            jcb = JB.ContendedBucket(*(jnp.asarray(t.numpy())
                                       for t in cb.tensors()))
            want = np.asarray(JB._contended_durations(
                jcb, L, JN.CONTENTION_ITERS))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0,
                                   err_msg=f"{(n_pad, P_pad, L)}")
    ref = JB.contended_bucket_delays(jitems, jnets)
    got = TB.contended_bucket_delays(titems, tnets, device=CPU)
    for r, d, o in zip(ref, got, _oracle(titems, tnets)):
        assert d.dtype == np.float64
        np.testing.assert_allclose(d, r, rtol=1e-12, atol=0)
        np.testing.assert_allclose(d, o, rtol=1e-6, atol=1e-9)


def test_contended_makespans_equal_reference_in_float32(x64, default_route):
    """``bucketed_makespans`` under ``maxmin_fair``: the port's default
    route on the CPU against the reference's default route (its jitted
    fixpoint), in float32."""
    jitems, titems, jnets, tnets = _netbound()
    seeds = [0, 1, 2]
    noise = J.NoiseModel("lognormal", 0.2)
    jt = [JB.sample_actual_batch(g, p, noise, seeds) for g, p in jitems]
    tt = [TB.sample_actual_batch(g, p, T.NoiseModel("lognormal", 0.2), seeds)
          for g, p in titems]
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a, b)
    assert JN.contention_kernel() == "jax"
    ref = JB.bucketed_makespans(jitems, jt, networks=jnets)
    got = TB.bucketed_makespans(titems, tt, networks=tnets, device=CPU)
    for r, g in zip(ref, got):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(r))


def test_contended_trace_counts_once_per_shape(default_route):
    _, titems, _, tnets = _netbound(n_scen=2, width=10, depth=4)
    _, groups = TB.contended_buckets(titems, tnets)
    TB.reset_trace_counts()
    TB._delay_overrides(titems, tnets, device=CPU)
    assert T.trace_count("contended") == len(groups) >= 1
    TB._delay_overrides(titems, tnets, device=CPU)
    assert T.trace_count("contended") == len(groups)
    TB.reset_trace_counts()
    TB._delay_overrides(titems, tnets, device=CPU)
    assert T.trace_count("contended") == 0


def test_set_contention_kernel_validates_and_numpy_routes_to_the_oracle(
        default_route):
    with pytest.raises(ValueError, match="unknown contention kernel"):
        T.set_contention_kernel("jax")
    assert T.contention_kernel() == "torch"
    _, titems, _, tnets = _netbound(n_scen=1)
    TB.reset_trace_counts()
    T.set_contention_kernel("numpy")
    assert T.contention_kernel() == "numpy"
    got = TB._delay_overrides(titems, tnets, device=CPU)
    assert T.trace_count("contended") == 0
    for d, o in zip(got, _oracle(titems, tnets)):
        np.testing.assert_array_equal(d, o)
    # the numpy route never reaches the device: a card is not asked for
    TB._delay_overrides(titems, tnets, device="cuda")
    T.set_contention_kernel("torch")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            TB._delay_overrides(titems, tnets)
        with pytest.raises(RuntimeError, match="is_available"):
            TB.build_plan_dag(*titems[0], network=tnets[0])


def test_environment_switch_changes_nothing():
    probe = ("import repro_torch.sim as T; print(T.contention_kernel())")
    env = {**os.environ, "REPRO_CONTENTION_KERNEL": "numpy",
           "PYTHONPATH": os.pathsep.join(sys.path)}
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert out.stdout.strip() == "torch"


def test_build_plan_dag_and_from_plans_price_on_the_given_device(
        default_route):
    _, titems, _, tnets = _netbound(n_scen=1)
    delays = TB.contended_bucket_delays(titems, tnets, device=CPU)
    for (g, p), net, d in zip(titems, tnets, delays):
        dag = TB.build_plan_dag(g, p, network=net, device=CPU)
        want = TB._plan_arrays(g, p, delay_e=d)[2]
        np.testing.assert_array_equal(dag.pred_delay.numpy(),
                                      TB._f32(want).numpy())
    bd = TB.BatchedPlanDag.from_plans(titems, networks=tnets, device=CPU)
    for b, ((g, p), d) in enumerate(zip(titems, delays)):
        want = TB._f32(TB._plan_arrays(g, p, delay_e=d)[2]).numpy()
        n, P = want.shape
        np.testing.assert_array_equal(bd.pred_delay[b, :n, :P].numpy(), want)


# ---------------------------------------------------- the kernel's loop
def test_kernel_loop_emulation_matches_plain_version():
    """The kernel's schedule (its stops, the frozen-plan skip, threads over
    transfers, strided where T_pad passes the block) bit for bit against
    the fixed-count plain version: the campaign netbound groups, a random
    bucket at 1, 2 and 4 iterations, the same bucket with a block of 32
    threads over 128 transfers, and the random transfer sets as one fluid
    solve each."""
    _, titems, _, tnets = _netbound(n_scen=3)
    _, groups = TB.contended_buckets(titems, tnets)
    cases = [(cb, L, TN.CONTENTION_ITERS, 512)
             for (_, _, L), (_, _, cb) in groups.items()]
    rand = random_bucket(np.random.default_rng(7), B=3, n=40, P=4, T=100)
    cases += [(rand, 4, iters, 512) for iters in (1, 2, 4)]
    cases.append((rand, 4, 4, 32))
    cases.append((fluid_bucket(random_transfer_sets()), 4, 4, 512))
    froze = 0
    for cb, L, iters, max_threads in cases:
        want = C.contended_durations(*cb.tensors(), num_links=L,
                                     iters=iters).numpy()
        got, counts = emulate(cb, L, iters, max_threads=max_threads)
        np.testing.assert_array_equal(got, want)
        assert (counts[:, 0] >= 1).all() and (counts[:, 0] <= iters).all()
        np.testing.assert_array_equal(counts[:, 3],
                                      counts[:, 0] * cb.order.shape[1])
        assert (counts[:, 1] <= counts[:, 0] * (3 * cb.size.shape[1] + 4)).all()
        froze += int((counts[:, 0] < iters).sum())
    assert froze >= 1, "no plan froze early: the skip went untested"


# ------------------------------------------------------------- wrapper
def test_wrapper_checks_and_shared_memory_sizing():
    rand = random_bucket(np.random.default_rng(3), B=2, n=16, P=4, T=32)
    args = list(rand.tensors())
    with pytest.raises(TypeError, match="size is torch.float32"):
        C.contended_durations(*args[:6], args[6].float(), *args[7:],
                              num_links=4, iters=4)
    with pytest.raises(ValueError, match="capacity has shape"):
        C.contended_durations(*args[:10], args[10][:1], num_links=4, iters=4)
    with pytest.raises(ValueError, match="needs the card"):
        C.launch(*args, num_links=4, iters=4)
    assert C.threads(1) == 32 and C.threads(100) == 128
    assert C.threads(1024) == 512
    # the campaign's shapes fit; a §6.1 fork-join join does not
    assert C.smem_bytes(64, 4, 64) < 48 * 1024
    assert C.smem_bytes(1024, 4, 1024) <= C.SMEM_LIMIT
    assert C.smem_bytes(4096, 4, 1024) > C.SMEM_LIMIT
    assert C.smem_bytes(1024, 4, 1024) == (
        8 * (1025 + 1024 + 4096 + 6 * 1024 + 64)
        + 4 * (1024 + 2 * 4096 + 3 * 1024 + 256) + 1024)
