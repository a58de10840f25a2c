"""The port's pipelined campaign executor against its serial route and
against the JAX package's executor.

``repro_torch.sim.pipeline`` must be unobservable in the results, as the
reference's is (``tests/test_pipeline.py``): ``pipelined_sweep_makespans``
equals the serial ``sweep_suite_makespans`` bit for bit for any worker
count and cache setting, and equals ``repro.sim.pipeline``'s on the same
entries, the per-entry network grid of the campaign's netbound sub-grid
(``maxmin_fair`` included) among them.  Cache hits return the same ``Plan``
object and count as the reference counts them; plan and graph
fingerprints equal the reference's.  The split of each bucket's plan axis
over a device list (the reference's mesh, ``tests/test_batch_shard.py``)
is held equal to the unsplit replay over ``[cpu] * k``.  Everything runs
on the CPU (``device="cpu"``: the plain versions of the kernels); the
reference's contended fixpoint runs with ``jax.enable_x64(True)`` standing
for the ``jax.experimental.enable_x64`` it imports (ROADMAP C1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental  # noqa: E402
import repro.sim as J  # noqa: E402
import repro.sim.pipeline as JP  # noqa: E402
import repro.sim.scenarios as JS  # noqa: E402
import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.batch as TB  # noqa: E402
import repro_torch.sim.pipeline as TP  # noqa: E402
import repro_torch.sim.scenarios as TS  # noqa: E402
from repro.sim.adapters import CommAwareHLPScheduler as JCAHLP  # noqa: E402
from repro_torch.obs import registry as _obs  # noqa: E402
from repro_torch.sim.adapters import CommAwareHLPScheduler as TCAHLP  # noqa: E402

CPU = "cpu"
SEEDS = [0, 1, 2]


def _entries(mod, n_sc=4, algs=("hlp_ols", "heft")):
    suite = mod.scenarios.default_suite(seed=0)[:n_sc]
    return [(sc.graph, sc.machine, mod.make_scheduler(a))
            for sc in suite for a in algs]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype == np.float32
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture
def x64(monkeypatch):
    """The reference's fixpoint with ``jax.enable_x64(True)`` standing for
    the ``jax.experimental.enable_x64`` it imports."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


# ------------------------------------------------------------------ parity
def test_pipelined_equals_serial_for_workers_and_cache():
    """workers 1, 2 and 4 (HLP-OLS through the process pool, HEFT through
    threads), each with the cache off and on."""
    noise = T.NoiseModel("lognormal", 0.2)
    entries = _entries(T)
    serial = TB.sweep_suite_makespans(entries, noise=noise, seeds=SEEDS,
                                      device=CPU)
    for workers in (1, 2, 4):
        for cache in (False, True):
            TP.clear_plan_cache()
            piped = TP.pipelined_sweep_makespans(
                entries, noise=noise, seeds=SEEDS, workers=workers,
                cache=cache, device=CPU)
            _same(serial, piped)
            assert TP.last_pipeline_stats().workers == workers


def test_pipelined_equals_the_reference_pipeline():
    tent, jent = _entries(T), _entries(J)
    TP.clear_plan_cache()
    JP.clear_plan_cache()
    got = TP.pipelined_sweep_makespans(
        tent, noise=T.NoiseModel("lognormal", 0.2), seeds=SEEDS, workers=2,
        device=CPU)
    want = JP.pipelined_sweep_makespans(
        jent, noise=J.NoiseModel("lognormal", 0.2), seeds=SEEDS, workers=2)
    _same(want, got)
    t, j = TP.last_pipeline_stats(), JP.last_pipeline_stats()
    assert (t.plans, t.buckets, t.cache_hits, t.cache_misses) == (
        j.plans, j.buckets, j.cache_hits, j.cache_misses)


def test_batch_entrypoint_routes_through_pipeline():
    noise = T.NoiseModel("lognormal", 0.2)
    entries = _entries(T, n_sc=2)
    serial = TB.sweep_suite_makespans(entries, noise=noise, seeds=SEEDS,
                                      device=CPU)
    for kw in ({"workers": 2}, {"cache": True}, {"workers": None}):
        TP.clear_plan_cache()
        _same(serial, TB.sweep_suite_makespans(
            entries, noise=noise, seeds=SEEDS, device=CPU, **kw))


def test_per_entry_network_grid_matches_serial_and_reference(x64):
    """The campaign's netbound phrasing (one flat entry per (allocation,
    network), the cache collapsing the repeated allocations) equals the
    per-network serial sweeps and the reference's pipelined sweep, with
    the reference's hit/miss counts, contended model included."""
    nets = ("instant", "fixed_latency", "maxmin_fair")
    sides = {}
    for mod, scen, cahlp in ((T, TS, TCAHLP), (J, JS, JCAHLP)):
        sc = scen.netbound_scenario(seed=300)
        mks = [lambda mod=mod: mod.make_scheduler("hlp_ols"),
               lambda cahlp=cahlp: cahlp(contention=True)]
        entries, networks = [], []
        for mk in mks:
            for net in nets:
                entries.append((sc.graph, sc.machine, mk()))
                networks.append(mod.make_network(net))
        sides[mod] = (sc, mks, entries, networks)
    sc, mks, entries, networks = sides[T]
    TP.clear_plan_cache()
    piped = TP.pipelined_sweep_makespans(
        entries, noise=T.NoiseModel("lognormal", 0.2), seeds=[0, 1],
        networks=networks, workers=1, device=CPU)
    stats = TP.last_pipeline_stats()
    assert (stats.cache_hits, stats.cache_misses) == (4, 2)
    for j, mk in enumerate(mks):
        for k, net in enumerate(networks[:3]):
            serial = TB.sweep_suite_makespans(
                [(sc.graph, sc.machine, mk())],
                noise=T.NoiseModel("lognormal", 0.2), seeds=[0, 1],
                network=net, device=CPU)
            _same(serial, [piped[j * 3 + k]])
    _, _, jentries, jnetworks = sides[J]
    JP.clear_plan_cache()
    want = JP.pipelined_sweep_makespans(
        jentries, noise=J.NoiseModel("lognormal", 0.2), seeds=[0, 1],
        networks=jnetworks, workers=1)
    _same(want, piped)
    assert (JP.last_pipeline_stats().cache_hits,
            JP.last_pipeline_stats().cache_misses) == (4, 2)


def test_plan_golden_hashes_bit_identical_across_workers():
    """Plan fingerprints for workers 1 and 4 equal the direct solves' and
    the reference's fingerprints of its own plans."""
    entries = _entries(T)
    golden = [TP.plan_fingerprint(s.allocate(g, m))
              for g, m, s in _entries(T)]
    assert golden == [JP.plan_fingerprint(s.allocate(g, m))
                      for g, m, s in _entries(J)]
    for workers in (1, 4):
        TP.clear_plan_cache()
        plans, build_s = TP.build_plans(entries, workers=workers, cache=True)
        assert [TP.plan_fingerprint(p) for p in plans] == golden
        assert build_s >= 0.0


# ---------------------------------------------------------- replay shapes
def test_envelope_compile_pin_and_no_retrace():
    """At most one new replay shape per envelope bucket; a repeated sweep
    adds none.  Seven seeds: a grid no other test of the port replays."""
    noise = T.NoiseModel("lognormal", 0.2)
    entries = _entries(T)
    envelopes = {TB.search_envelope(g, m) for g, m, _ in entries}
    TP.clear_plan_cache()
    t0 = TB.trace_count("bucket")
    TP.pipelined_sweep_makespans(entries, noise=noise, seeds=range(7),
                                 device=CPU)
    t1 = TB.trace_count("bucket")
    assert 1 <= t1 - t0 <= len(envelopes)
    assert TP.last_pipeline_stats().buckets == len(envelopes)
    TP.pipelined_sweep_makespans(entries, noise=noise, seeds=range(7),
                                 device=CPU)
    assert TB.trace_count("bucket") == t1


def test_overlap_is_measured():
    entries = _entries(T)
    TP.clear_plan_cache()
    TP.pipelined_sweep_makespans(entries, noise=T.NoiseModel("lognormal", 0.2),
                                 seeds=SEEDS, device=CPU)
    stats = TP.last_pipeline_stats()
    assert stats.plans == len(entries) and stats.buckets >= 2
    assert stats.total_s > 0 and stats.overlap_frac > 0
    assert 0 < stats.build_wall_s < stats.total_s
    assert stats.cache_hits + stats.cache_misses == len(entries)
    gauges = _obs.gauges()
    assert gauges["sim.pipeline.overlap_frac"] == stats.overlap_frac
    assert gauges["sim.pipeline.plan_build_s"] == stats.plan_build_s


# -------------------------------------------------------------- plan cache
def test_cache_hit_returns_same_plan_object_and_counts():
    """The same sequence of allocations through both packages' caches: the
    same object on a hit, and equal hit/miss deltas."""
    from repro.obs import registry as jobs

    deltas = {}
    for mod, pipe, reg in ((T, TP, _obs), (J, JP, jobs)):
        sc = mod.scenarios.default_suite(seed=0)[0]
        pipe.clear_plan_cache()
        h0 = reg.counter_value("plan_cache.hits")
        m0 = reg.counter_value("plan_cache.misses")
        p1 = pipe.cached_allocate(mod.make_scheduler("hlp_ols"), sc.graph,
                                  sc.machine)
        p2 = pipe.cached_allocate(mod.make_scheduler("hlp_ols"), sc.graph,
                                  sc.machine)
        assert p2 is p1
        pipe.cached_allocate(mod.make_scheduler("heft"), sc.graph, sc.machine)
        pipe.cached_allocate(mod.make_scheduler("hlp_ols"), sc.graph,
                             sc.machine, cache=False)
        pipe.clear_plan_cache()
        p3 = pipe.cached_allocate(mod.make_scheduler("hlp_ols"), sc.graph,
                                  sc.machine)
        assert p3 is not p1
        assert pipe.plan_fingerprint(p3) == pipe.plan_fingerprint(p1)
        deltas[mod] = (reg.counter_value("plan_cache.hits") - h0,
                       reg.counter_value("plan_cache.misses") - m0)
    assert deltas[T] == deltas[J] == (1, 3)


def test_uncacheable_schedulers_bypass_the_cache():
    sc = TS.default_suite(seed=0)[0]
    assert TP.plan_cache_key(sc.graph, sc.machine,
                             T.make_scheduler("er_ls")) is None
    plan = T.make_scheduler("hlp_ols").allocate(sc.graph, sc.machine)
    frozen = T.FrozenPlanScheduler(plan, name="hlp_ols")
    assert TP.plan_cache_key(sc.graph, sc.machine, frozen) is None
    TP.clear_plan_cache()
    m0 = _obs.counter_value("plan_cache.misses")
    assert TP.cached_allocate(frozen, sc.graph, sc.machine) is plan
    assert _obs.counter_value("plan_cache.misses") == m0


def test_cached_solve_dedupes_named_builders():
    sc = TS.default_suite(seed=0)[0]
    calls = []

    def build():
        calls.append(1)
        return T.make_scheduler("heft").allocate(sc.graph, sc.machine)

    TP.clear_plan_cache()
    p1 = TP.cached_solve("test.build", sc.graph, sc.machine, build)
    p2 = TP.cached_solve("test.build", sc.graph, sc.machine, build)
    assert p2 is p1 and len(calls) == 1
    p3 = TP.cached_solve("test.build", sc.graph, sc.machine, build,
                         extra=("other",))
    assert len(calls) == 2 and p3 is not None
    assert TP.plan_cache_stats()["entries"] == 2


def test_graph_fingerprint_is_content_addressed_and_the_reference_s():
    a, b = TS.default_suite(seed=0)[0], TS.default_suite(seed=0)[0]
    assert a.graph is not b.graph
    assert TP.graph_fingerprint(a.graph) == TP.graph_fingerprint(b.graph)
    other = TS.default_suite(seed=0)[1]
    assert TP.graph_fingerprint(a.graph) != TP.graph_fingerprint(other.graph)
    for t, j in zip(TS.default_suite(seed=0) + TS.comm_suite(seed=50),
                    JS.default_suite(seed=0) + JS.comm_suite(seed=50)):
        assert TP.graph_fingerprint(t.graph) == JP.graph_fingerprint(j.graph)


# ------------------------------------------------------------------- knobs
def test_plan_workers_setting(monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_WORKERS", "3")
    assert TP.plan_workers() == 3
    monkeypatch.setenv("REPRO_PLAN_WORKERS", "0")
    assert TP.plan_workers() == 1
    monkeypatch.delenv("REPRO_PLAN_WORKERS")
    assert TP.plan_workers() >= 1
    monkeypatch.setenv("REPRO_PLAN_POOL", "serial")
    assert TP._pool_kind(T.make_scheduler("hlp_ols")) == "serial"
    monkeypatch.delenv("REPRO_PLAN_POOL")
    assert TP._pool_kind(T.make_scheduler("hlp_ols")) == "process"
    assert TP._pool_kind(T.make_scheduler("heft")) == "thread"
    assert TP._pool_kind(T.make_scheduler("evo", device=CPU)) == "thread"


def test_process_pool_parity(monkeypatch):
    """LP-heavy adapters through the persistent forkserver pool: the same
    plans, and the pool survives (no fallback) under pytest's guarded
    ``__main__``."""
    entries = _entries(T, n_sc=2, algs=("hlp_est",))
    golden = [TP.plan_fingerprint(s.allocate(g, m))
              for g, m, s in _entries(T, n_sc=2, algs=("hlp_est",))]
    monkeypatch.setenv("REPRO_PLAN_POOL", "process")
    broken0 = _obs.counter_value("plan_pool.broken")
    TP.clear_plan_cache()
    plans, _ = TP.build_plans(entries, workers=2, cache=False)
    assert [TP.plan_fingerprint(p) for p in plans] == golden
    assert _obs.counter_value("plan_pool.broken") == broken0


# ------------------------------------------------------- plan-axis split
def test_plan_axis_split_over_devices_equals_unsplit():
    """Plan counts 1, 4, 5 and 7 over 1-4 CPU devices: the padded round
    trip (repeats of plan 0, sliced back) and the replay equal the whole
    bucket's, bit for bit, through the evaluators' ``devices=``."""
    rng = np.random.default_rng(0)
    suite = TS.default_suite(seed=0)
    items = [(sc.graph, T.make_scheduler("heft").allocate(sc.graph,
                                                          sc.machine))
             for sc in suite]
    for B, multiple in ((7, 4), (5, 3), (4, 4), (1, 8)):
        args = tuple(torch.from_numpy(rng.random((B, 3, 2))) for _ in "ab")
        padded = TB._pad_plan_axis(args, multiple)
        assert padded[0].shape[0] % multiple == 0
        assert torch.equal(padded[0][:B], args[0])
        assert (padded[1][B:] == args[1][0]).all()
    for B in (1, 4, 5, 7):
        sub = [items[i % len(items)] for i in range(B)]
        rows = [TB.sample_actual_batch(g, p, T.NoiseModel("lognormal", 0.2),
                                       range(3)) for g, p in sub]
        whole = TB.bucketed_makespans(sub, rows, device=CPU)
        for k in (1, 2, 3, 4):
            _same(whole, TB.bucketed_makespans(sub, rows, device=CPU,
                                               devices=[CPU] * k))
        keys = [TB._bucket_key(g, p) for g, p in sub]
        pad_to = (max(k[0] for k in keys), max(k[1] for k in keys))
        flat = TB.fixed_envelope_makespans(sub, rows, pad_to, device=CPU)
        _same(flat, TB.fixed_envelope_makespans(sub, rows, pad_to,
                                                device=CPU,
                                                devices=[CPU] * 3))


def test_campaign_devices_default_set_and_reset(monkeypatch):
    assert TB.campaign_devices(CPU) == [torch.device(CPU)]
    entries = _entries(T, n_sc=2)
    noise = T.NoiseModel("lognormal", 0.2)
    serial = TB.sweep_suite_makespans(entries, noise=noise, seeds=SEEDS,
                                      device=CPU)
    try:
        T.set_campaign_devices([CPU, CPU])
        assert TB.campaign_devices(CPU) == [torch.device(CPU)] * 2
        TP.clear_plan_cache()
        _same(serial, TB.sweep_suite_makespans(
            entries, noise=noise, seeds=SEEDS, device=CPU, workers=2))
        with pytest.raises(ValueError, match="at least one device"):
            T.set_campaign_devices([])
        # an installed card list never captures a "cpu" request
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        T.set_campaign_devices(["cuda:0", "cuda:1"])
        assert TB.campaign_devices(CPU) == [torch.device(CPU)]
    finally:
        T.set_campaign_devices(None)
    assert TB.campaign_devices(CPU) == [torch.device(CPU)]
