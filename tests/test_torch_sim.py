"""The port's simulator against the JAX package's, bit for bit.

``tests/golden_width1.json`` holds the reference's makespans and SHA-256
schedule hashes for every adapter; the port's ``simulate`` must reproduce
each one (clean and under seeded lognormal noise) for every adapter it
carries.  ``hlp_jax_ols`` needs the first-order LP, which the port does not
have yet, and the ``evo`` adapters have no golden cells.  Beyond the
goldens, every ported static adapter runs the communication-carrying
default suite under the three network models, and the network helpers run
on a contended instance, each against ``repro.sim`` in the same process.
"""
import dataclasses
import hashlib
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.sim as J  # noqa: E402
import repro.sim.network as JN  # noqa: E402
import repro.sim.scenarios as JS  # noqa: E402
import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.network as TN  # noqa: E402
import repro_torch.sim.scenarios as TS  # noqa: E402

with open(os.path.join(os.path.dirname(__file__), "golden_width1.json")) as _f:
    GOLDEN_W1 = json.load(_f)

NOT_PORTED = {"hlp_jax_ols", "evo", "evo_camhlp"}
STATIC = ("hlp_est", "hlp_ols", "cahlp_ols", "camhlp_ols", "mhlp_ols",
          "heft", "heft_nocomm")
NETWORKS = ("instant", "fixed_latency", "maxmin_fair")


def _sched_hash(s) -> str:
    h = hashlib.sha256()
    for a in (np.asarray(s.alloc, np.int64), np.asarray(s.proc, np.int64),
              np.asarray(s.start, np.float64),
              np.asarray(s.finish, np.float64)):
        h.update(a.tobytes())
    return h.hexdigest()


def _w1_suite(mod):
    """The golden fixture's scenarios (as ``tests/test_sim_golden.py``)."""
    return {sc.name: sc for sc in list(mod.default_suite(seed=0))
            + [mod.random_scenario(n=9, seed=7, counts=(3, 2))]}


# Tests loop over their cases rather than being parametrized per case: a
# file of many short items changes the order in which pytest-xdist hands
# whole files to its workers, and some of the JAX package's tests count XLA
# compiles in a process whose other files share its jit cache.


def test_adapters_are_the_reference_less_the_unported():
    assert set(T.ADAPTERS) == set(J.ADAPTERS) - NOT_PORTED
    covered = {alg for cells in GOLDEN_W1.values() for alg in cells}
    assert covered - NOT_PORTED <= set(T.ADAPTERS)


@pytest.mark.parametrize("scenario", sorted(GOLDEN_W1))
def test_width1_golden_replays_bit_for_bit(scenario):
    sc = _w1_suite(TS)[scenario]
    g = sc.graph.with_speedup(np.ones((sc.graph.n, 1)))
    cells = {a: e for a, e in GOLDEN_W1[scenario].items() if a not in NOT_PORTED}
    assert cells
    for alg, exp in sorted(cells.items()):
        r0 = T.simulate(g, sc.machine, T.make_scheduler(alg), seed=sc.seed)
        r1 = T.simulate(g, sc.machine, T.make_scheduler(alg),
                        noise=T.NoiseModel("lognormal", 0.2), seed=sc.seed)
        assert r0.makespan == exp["clean"], alg
        assert r1.makespan == exp["noisy"], alg
        assert _sched_hash(r0.schedule) == exp["hash_clean"], alg
        assert _sched_hash(r1.schedule) == exp["hash_noisy"], alg


def _same_run(jr, tr, case=None):
    assert tr.makespan == jr.makespan, case
    assert _sched_hash(tr.schedule) == _sched_hash(jr.schedule), case
    np.testing.assert_array_equal(tr.actual, jr.actual, err_msg=str(case))
    assert [dataclasses.astuple(e) for e in tr.trace] == \
        [dataclasses.astuple(e) for e in jr.trace], case


@pytest.mark.parametrize("network", NETWORKS)
def test_default_suite_under_networks_equals_reference(network):
    jsuite = J.scenarios.default_suite(seed=0, ccr=1.0)
    tsuite = T.scenarios.default_suite(seed=0, ccr=1.0)
    for alg in STATIC:
        for jsc, tsc in zip(jsuite, tsuite):
            assert jsc.name == tsc.name
            kw = dict(noise=None, seed=jsc.seed, trace=True)
            jr = J.simulate(jsc.graph, jsc.machine, J.make_scheduler(alg),
                            network=J.make_network(network), **kw)
            tr = T.simulate(tsc.graph, tsc.machine, T.make_scheduler(alg),
                            network=T.make_network(network), **kw)
            _same_run(jr, tr, (alg, jsc.name))


@pytest.mark.parametrize("arrival", ["order", "ready"])
def test_online_adapters_under_noise_and_release_equal_reference(arrival):
    jsc = JS.make_scenario("layered", n=40, layers=5, seed=2, ccr=0.5)
    tsc = TS.make_scenario("layered", n=40, layers=5, seed=2, ccr=0.5)
    release = np.random.default_rng(0).uniform(0, 5, jsc.graph.n)
    kw = dict(seed=3, release=release, arrival=arrival)
    for alg in ("er_ls", "eft", "greedy_r2", "random"):
        jr = J.simulate(jsc.graph, jsc.machine, J.make_scheduler(alg),
                        noise=J.NoiseModel("uniform", 0.3), **kw)
        tr = T.simulate(tsc.graph, tsc.machine, T.make_scheduler(alg),
                        noise=T.NoiseModel("uniform", 0.3), **kw)
        _same_run(jr, tr, alg)


def test_moldable_suite_equals_reference():
    for seed in (0, 3):
        jsc = JS.moldable_suite(seed=seed, num=1, ccr=0.5)[0]
        tsc = TS.moldable_suite(seed=seed, num=1, ccr=0.5)[0]
        for alg in ("mhlp_ols", "camhlp_ols", "er_ls", "eft"):
            _same_run(J.simulate(jsc.graph, jsc.machine, J.make_scheduler(alg),
                                 noise=J.NoiseModel("lognormal", 0.2),
                                 seed=seed),
                      T.simulate(tsc.graph, tsc.machine, T.make_scheduler(alg),
                                 noise=T.NoiseModel("lognormal", 0.2),
                                 seed=seed), (alg, seed))


def test_network_helpers_equal_reference():
    for seed in (0, 1, 4):
        _network_helpers_equal(seed)
    _transfer_trackers_equal()


def _network_helpers_equal(seed):
    jsc = JS.netbound_scenario(seed=seed)
    tsc = TS.netbound_scenario(seed=seed)
    jplan = J.plan_for("hlp_ols", jsc.graph, jsc.machine)
    tplan = T.plan_for("hlp_ols", tsc.graph, tsc.machine)
    np.testing.assert_array_equal(jplan.alloc, tplan.alloc)
    assert jplan.sequences == tplan.sequences
    jnet, tnet = JN.MaxMinFairNetwork(), TN.MaxMinFairNetwork()
    jt, tt = JN.plan_transfers(jsc.graph, jplan, jnet), \
        TN.plan_transfers(tsc.graph, tplan, tnet)
    for f in dataclasses.fields(jt):
        a, b = getattr(jt, f.name), getattr(tt, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    actual = jsc.graph.proc * np.random.default_rng(seed).uniform(
        0.8, 1.2, jsc.graph.proc.shape)
    times = J.plan_times(jsc.graph, jplan, actual)
    np.testing.assert_array_equal(times, T.plan_times(tsc.graph, tplan, actual))
    np.testing.assert_array_equal(
        JN.contended_plan_delays(jsc.graph, jplan, times, jnet),
        TN.contended_plan_delays(tsc.graph, tplan, times, tnet))
    np.testing.assert_array_equal(JN.maxmin_rates(jt.links()),
                                  TN.maxmin_rates(tt.links()))
    _same_run(J.simulate(jsc.graph, jsc.machine, J.FrozenPlanScheduler(jplan),
                         network=jnet, trace=True),
              T.simulate(tsc.graph, tsc.machine, T.FrozenPlanScheduler(tplan),
                         network=tnet, trace=True))


def _transfer_trackers_equal():
    jnet, tnet = JN.MaxMinFairNetwork(), TN.MaxMinFairNetwork()
    jtrk, ttrk = JN.TransferTracker(jnet), TN.TransferTracker(tnet)
    rng = np.random.default_rng(5)
    for _ in range(12):
        t0, size = float(rng.uniform(0, 4)), float(rng.uniform(0.1, 3))
        src, dst = (int(x) for x in rng.permutation(2))
        assert jtrk.estimate(t0, size, jnet.links_of(src, dst)) == \
            ttrk.estimate(t0, size, tnet.links_of(src, dst))
        assert jtrk.register(t0, size, jnet.links_of(src, dst)) == \
            ttrk.register(t0, size, tnet.links_of(src, dst))


def test_scenario_families_equal_reference():
    assert sorted(JS.SCENARIO_FAMILIES) == sorted(TS.SCENARIO_FAMILIES)
    for family in sorted(TS.SCENARIO_FAMILIES):
        jsc, tsc = JS.make_scenario(family, seed=1), TS.make_scenario(family,
                                                                      seed=1)
        assert (jsc.name, jsc.family, jsc.seed) == (tsc.name, tsc.family,
                                                    tsc.seed)
        assert jsc.machine.counts == tsc.machine.counts
        np.testing.assert_array_equal(jsc.graph.proc, tsc.graph.proc)
        np.testing.assert_array_equal(jsc.graph.edges, tsc.graph.edges)
        np.testing.assert_array_equal(jsc.graph.comm, tsc.graph.comm)
