"""The port's replay evaluator against the JAX package's, in float32, exactly.

``repro_torch.sim.batch`` on the CPU (the replay kernel's plain version,
``kernels/replay/ref.py``) is held against ``repro.sim.batch`` in the same
process with the reference's plan-axis sharding off
(``REPRO_SHARD_BACKEND=none``): the padded plan tensors, the buckets and
every makespan must be equal, in float32, over ``default_suite``,
``comm_suite`` and ``moldable_suite`` × every ported static adapter, with
floors, with envelopes and under the three network models (both
packages' contended routes through their numpy oracles).  The float64
engine agrees to rtol 1e-5, as in ``tests/test_sim_comm.py``.  The CUDA
kernel runs only on the card (``tests/test_torch_replay_card.py``); here
its loop is emulated in numpy float32 and held to the plain version.

Tests loop over their cases rather than being parametrized per case: a
file of many items changes the order in which pytest-xdist hands whole
files to its workers, and some of the JAX package's tests count XLA
compiles in a process whose other files share its jit cache.  For the same
reason no reference call here replays 16 plans at a 64-task envelope, the
shape ``tests/test_search.py`` compiles.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.sim as J  # noqa: E402
import repro.sim.batch as JB  # noqa: E402
import repro.sim.network as JN  # noqa: E402
import repro.sim.scenarios as JS  # noqa: E402
import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.batch as TB  # noqa: E402
import repro_torch.sim.scenarios as TS  # noqa: E402
from repro_torch.kernels.replay import replay as R  # noqa: E402

STATIC = ("hlp_est", "hlp_ols", "cahlp_ols", "camhlp_ols", "mhlp_ols",
          "heft", "heft_nocomm")
NETWORKS = ("instant", "fixed_latency", "maxmin_fair")
SEEDS = list(range(5))
CPU = "cpu"


@pytest.fixture(autouse=True)
def _no_sharding(monkeypatch):
    monkeypatch.setenv("REPRO_SHARD_BACKEND", "none")


def _suite(mod):
    return (list(mod.default_suite(seed=0))
            + list(mod.comm_suite(seed=50, ccr=0.5))
            + list(mod.moldable_suite(seed=0, num=2, ccr=0.5)))


@functools.cache
def _grid():
    """(names, reference items, port items): every scenario of the three
    suites × every static adapter, planned by each package, plus the
    branch-and-bound oracle on an instance small enough for it."""
    names, jitems, titems = [], [], []
    pairs = list(zip(_suite(JS), _suite(TS)))
    for jsc, tsc in pairs:
        assert jsc.name == tsc.name
        for alg in STATIC:
            names.append((jsc.name, alg))
            jitems.append((jsc.graph, J.make_scheduler(alg).allocate(
                jsc.graph, jsc.machine)))
            titems.append((tsc.graph, T.make_scheduler(alg).allocate(
                tsc.graph, tsc.machine)))
    jsc = JS.make_scenario("random", n=7, counts=(2, 1), seed=3, ccr=0.5)
    tsc = TS.make_scenario("random", n=7, counts=(2, 1), seed=3, ccr=0.5)
    names.append((jsc.name, "bruteforce"))
    jitems.append((jsc.graph, J.make_scheduler("bruteforce").allocate(
        jsc.graph, jsc.machine)))
    titems.append((tsc.graph, T.make_scheduler("bruteforce").allocate(
        tsc.graph, tsc.machine)))
    machines = [(j.machine, t.machine) for j, t in pairs
                for _ in STATIC] + [(jsc.machine, tsc.machine)]
    return names, jitems, titems, machines


def _times(jitems, titems, noise=("lognormal", 0.2), seeds=SEEDS):
    """Each package's (S, n) noise grid for its own items, held equal."""
    jt = [JB.sample_actual_batch(g, p, J.NoiseModel(*noise), seeds)
          for g, p in jitems]
    tt = [TB.sample_actual_batch(g, p, T.NoiseModel(*noise), seeds)
          for g, p in titems]
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a, b)
    return jt, tt


def _floors(items, machines, rng):
    """Busy-machine floors from random per-processor horizons."""
    out = []
    for (g, plan), m in zip(items, machines):
        busy = [rng.uniform(0, 5, c) for c in m.counts]
        out.append(TB.rollout_floors(g, plan, busy, now=1.0))
    return out


def _same(ref, got, case=None):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        a = np.asarray(a)
        assert a.dtype == np.float32 and b.dtype == np.float32, (case, i)
        np.testing.assert_array_equal(b, a, err_msg=f"{case} item {i}")


def _kernel_emulation(order, pred, delay, floor, times):
    """The loop of ``csrc/replay.cu`` in numpy float32, lane by lane: the
    finish column starts at zeros, the slot loop stops at the first -1, and
    the makespan is the max over the whole column after the walk."""
    order, pred = order.numpy(), pred.numpy()
    delay, floor, times = delay.numpy(), floor.numpy(), times.numpy()
    B, n_pad, P = pred.shape
    S = times.shape[1]
    out = np.empty((B, S), np.float32)
    for b in range(B):
        for s in range(S):
            finish = np.zeros(n_pad, np.float32)
            for j in order[b]:
                start = np.float32(0)
                for k in range(P):
                    p = pred[b, j, k]
                    if p < 0:
                        break
                    start = max(start, np.float32(finish[p] + delay[b, j, k]))
                start = max(start, floor[b, j])
                finish[j] = np.float32(start + times[b, s, j])
            best = finish[0]
            for f in finish[1:]:
                best = max(best, f)
            out[b, s] = best
    return out


# ---------------------------------------------------------------- host half
def test_plan_tensors_buckets_and_noise_equal_reference():
    names, jitems, titems, machines = _grid()
    rng = np.random.default_rng(0)
    for name, (jg, jp), (tg, tp), (jm, tm) in zip(names, jitems, titems,
                                                  machines):
        for a, b in zip(JB._plan_arrays(jg, jp), TB._plan_arrays(tg, tp)):
            np.testing.assert_array_equal(b, a, err_msg=str(name))
        assert TB._bucket_key(tg, tp) == JB._bucket_key(jg, jp), name
        assert TB.search_envelope(tg, tm) == JB.search_envelope(jg, jm), name
        seeds = rng.integers(0, 1000, 3).tolist()
        np.testing.assert_array_equal(
            TB.sample_actual_batch(tg, tp, T.NoiseModel("uniform", 0.3), seeds),
            JB.sample_actual_batch(jg, jp, J.NoiseModel("uniform", 0.3), seeds))
    assert TB.bucket_plans(titems) == JB.bucket_plans(jitems)


def test_batched_plan_dag_equals_reference():
    names, jitems, titems, machines = _grid()
    floors = _floors(titems, [m for _, m in machines],
                     np.random.default_rng(1))
    for key, idxs in TB.bucket_plans(titems).items():
        for pad_to in (None, key):
            for fl in (None, [floors[i] for i in idxs]):
                ref = JB.BatchedPlanDag.from_plans(
                    [jitems[i] for i in idxs], floors=fl, pad_to=pad_to)
                got = TB.BatchedPlanDag.from_plans(
                    [titems[i] for i in idxs], floors=fl, pad_to=pad_to)
                assert (got.batch, got.n_pad) == (ref.batch, ref.n_pad)
                for field in ("order", "pred", "pred_mask", "pred_delay",
                              "floor", "width"):
                    a = np.asarray(getattr(ref, field))
                    b = getattr(got, field).numpy()
                    assert b.dtype == a.dtype, (key, field)
                    np.testing.assert_array_equal(b, a, err_msg=f"{key} {field}")


# ---------------------------------------------------------------- makespans
def test_bucketed_makespans_equal_reference_in_float32():
    """Plain, with rollout floors, and padded to the full envelope."""
    names, jitems, titems, machines = _grid()
    jt, tt = _times(jitems, titems)
    floors = _floors(titems, [m for _, m in machines],
                     np.random.default_rng(2))
    for kw in ({}, {"floors": floors}, {"envelope": True},
               {"floors": floors, "envelope": True}):
        ref = JB.bucketed_makespans(jitems, jt, **kw)
        got = TB.bucketed_makespans(titems, tt, device=CPU, **kw)
        _same(ref, got, sorted(kw))


def test_bucketed_makespans_under_networks_equal_reference():
    """instant, fixed_latency and maxmin_fair; both packages price the
    contended model through their numpy oracles here (the whole-bucket
    fixpoints are held in ``tests/test_torch_contention.py``)."""
    _, jitems, titems, _ = _grid()
    jt, tt = _times(jitems, titems, seeds=[0, 1, 2])
    was = JN.contention_kernel()
    JN.set_contention_kernel("numpy")
    T.set_contention_kernel("numpy")
    TB.reset_trace_counts()
    try:
        for net in NETWORKS:
            ref = JB.bucketed_makespans(
                jitems, jt, networks=[J.make_network(net)] * len(jitems))
            got = TB.bucketed_makespans(
                titems, tt, networks=[T.make_network(net)] * len(titems),
                device=CPU)
            _same(ref, got, net)
    finally:
        JN.set_contention_kernel(was)
        T.set_contention_kernel("torch")
    assert TB.trace_count("contended") == 0


def test_fixed_envelope_batch_and_sweep_makespans_equal_reference():
    jsc = JS.make_scenario("layered", n=40, layers=5, counts=(8, 2), seed=2,
                           ccr=0.5)
    tsc = TS.make_scenario("layered", n=40, layers=5, counts=(8, 2), seed=2,
                           ccr=0.5)
    jitems = [(jsc.graph, J.make_scheduler(a).allocate(jsc.graph, jsc.machine))
              for a in STATIC]
    titems = [(tsc.graph, T.make_scheduler(a).allocate(tsc.graph, tsc.machine))
              for a in STATIC]
    jt, tt = _times(jitems, titems, seeds=list(range(6)))
    env = TB.search_envelope(tsc.graph, tsc.machine)
    assert env == JB.search_envelope(jsc.graph, jsc.machine)
    assert len(titems) != 16
    floors = _floors(titems, [tsc.machine] * len(titems),
                     np.random.default_rng(3))
    for fl in (None, floors):
        _same(JB.fixed_envelope_makespans(jitems, jt, env, floors=fl),
              TB.fixed_envelope_makespans(titems, tt, env, floors=fl,
                                          device=CPU), "fixed envelope")
    with pytest.raises(ValueError, match="envelope"):
        TB.fixed_envelope_makespans(titems, tt, (env[0] // 2, env[1]),
                                    device=CPU)
    assert TB.fixed_envelope_makespans([], [], env, device=CPU) == []
    for (jg, jp), (tg, tp), a, b in zip(jitems, titems, jt, tt):
        _same([JB.batch_makespans(jg, jp, a)],
              [TB.batch_makespans(tg, tp, b, device=CPU)], "batch")
    for alg in ("hlp_ols", "heft"):
        noise = ("lognormal", 0.1)
        _same([JB.sweep_makespans(jsc.graph, jsc.machine,
                                  J.make_scheduler(alg),
                                  noise=J.NoiseModel(*noise), seeds=[3, 4])],
              [TB.sweep_makespans(tsc.graph, tsc.machine,
                                  T.make_scheduler(alg),
                                  noise=T.NoiseModel(*noise), seeds=[3, 4],
                                  device=CPU)], alg)


def test_sweep_suite_makespans_equals_reference_and_refuses_the_pipeline(
        monkeypatch):
    """The serial route against the reference's, and (since the pipelined
    executor is ported) ``workers`` / ``cache`` routed through it, equal to
    the reference's pipelined route on the same entries."""
    jsuite = JS.comm_suite(seed=0, ccr=0.6) + JS.moldable_suite(seed=1, num=1)
    tsuite = TS.comm_suite(seed=0, ccr=0.6) + TS.moldable_suite(seed=1, num=1)
    algs = ("hlp_est", "mhlp_ols", "heft")
    jent = [(sc.graph, sc.machine, J.make_scheduler(a))
            for sc in jsuite for a in algs]
    tent = [(sc.graph, sc.machine, T.make_scheduler(a))
            for sc in tsuite for a in algs]

    def floor_fn(g, plan):
        return np.linspace(0.0, 2.0, g.n)

    for kw in ({}, {"envelope": True, "floor_fn": floor_fn}):
        ref = JB.sweep_suite_makespans(jent, noise=J.NoiseModel("uniform", 0.3),
                                       seeds=[0, 1, 2], **kw)
        got = TB.sweep_suite_makespans(tent, noise=T.NoiseModel("uniform", 0.3),
                                       seeds=[0, 1, 2], device=CPU, **kw)
        _same(ref, got, sorted(kw))
    monkeypatch.setenv("REPRO_PLAN_WORKERS", "2")
    for kw in ({"workers": 2}, {"workers": None}, {"cache": True}):
        ref = JB.sweep_suite_makespans(jent, noise=J.NoiseModel("uniform", 0.3),
                                       seeds=[0, 1, 2], **kw)
        got = TB.sweep_suite_makespans(tent, noise=T.NoiseModel("uniform", 0.3),
                                       seeds=[0, 1, 2], device=CPU, **kw)
        _same(ref, got, sorted(kw))


def test_engine_agrees_and_zero_noise_replays_the_plan():
    """The two cases of tests/test_sim_comm.py:149-176 at rtol 1e-5 against
    the port's float64 engine, and its zero-noise row (:179)."""
    noise = T.NoiseModel("lognormal", 0.2)
    seeds = list(range(8))
    for sc in (TS.make_scenario("random", n=25, counts=(8, 2), seed=2,
                                ccr=0.8),
               TS.netbound_scenario(width=8, depth=3, counts=(4, 2), seed=1)):
        for name in ("hlp_ols", "heft", "heft_nocomm"):
            ms = TB.sweep_makespans(sc.graph, sc.machine,
                                    T.make_scheduler(name), noise=noise,
                                    seeds=seeds, device=CPU)
            ref = [T.simulate(sc.graph, sc.machine, T.make_scheduler(name),
                              noise=noise, seed=s).makespan for s in seeds]
            np.testing.assert_allclose(ms, ref, rtol=1e-5)
    noise = T.NoiseModel("uniform", 0.3)
    entries, refs = [], []
    for sc in TS.comm_suite(seed=0, ccr=0.6):
        for name in ("hlp_est", "heft"):
            entries.append((sc.graph, sc.machine, T.make_scheduler(name)))
            refs.append([T.simulate(sc.graph, sc.machine,
                                    T.make_scheduler(name), noise=noise,
                                    seed=s).makespan for s in range(6)])
    out = TB.sweep_suite_makespans(entries, noise=noise, seeds=range(6),
                                   device=CPU)
    np.testing.assert_allclose(np.asarray(out), np.asarray(refs), rtol=1e-5)

    sc = TS.make_scenario("layered", n=40, layers=5, counts=(8, 2), seed=2,
                          ccr=0.5)
    plan = T.make_scheduler("heft").allocate(sc.graph, sc.machine)
    row = TB.sample_actual_batch(sc.graph, plan, T.NoiseModel(), [0])
    ms = TB.bucketed_makespans([(sc.graph, plan)], [row], device=CPU)[0][0]
    ref = T.simulate(sc.graph, sc.machine, T.make_scheduler("heft"),
                     seed=0).makespan
    assert ms == pytest.approx(ref, rel=1e-5)


# ------------------------------------------------------- counters and errors
def test_trace_counts_one_per_bucket_and_none_on_a_rerun():
    _, _, titems, _ = _grid()
    # 7 seeds: no other test here replays S = 7, so every shape is new
    rows = [TB.sample_actual_batch(g, p, T.NoiseModel("lognormal", 0.15),
                                   range(7, 14)) for g, p in titems]
    n_buckets = len(TB.bucket_plans(titems))
    TB.reset_trace_counts()
    TB.bucketed_makespans(titems, rows, device=CPU)
    assert 1 <= TB.trace_count("bucket") <= n_buckets
    TB.reset_trace_counts()
    TB.bucketed_makespans(titems, rows, device=CPU)
    assert TB.trace_count("bucket") == 0
    g, p = titems[0]
    TB.batch_makespans(g, p, rows[0][:2], device=CPU)
    TB.batch_makespans(g, p, rows[0][2:4], device=CPU)
    assert TB.trace_count("single") <= 1
    assert T.trace_count("contended") == 0
    with pytest.raises(ValueError, match="valid kinds"):
        TB.trace_count("nope")
    TB.reset_trace_counts()
    assert [TB.trace_count(k) for k in TB.TRACE_KINDS] == [0, 0, 0]
    assert T.reset_trace_counts is TB.reset_trace_counts


def test_bucketed_rejects_misaligned_inputs():
    sc = TS.make_scenario("chain", n=8, counts=(2, 1), seed=0)
    plan = T.make_scheduler("heft").allocate(sc.graph, sc.machine)
    with pytest.raises(ValueError):
        TB.bucketed_makespans([(sc.graph, plan)], [], device=CPU)
    with pytest.raises(ValueError):
        TB.bucketed_makespans([(sc.graph, plan)],
                              [np.zeros((3, sc.graph.n + 1))], device=CPU)
    sc2 = TS.make_scenario("chain", n=6, counts=(2, 1), seed=1)
    plan2 = T.make_scheduler("heft").allocate(sc2.graph, sc2.machine)
    with pytest.raises(ValueError, match="seed grid"):
        TB.bucketed_makespans([(sc.graph, plan), (sc2.graph, plan2)],
                              [np.zeros((3, sc.graph.n)),
                               np.zeros((4, sc2.graph.n))], device=CPU)
    with pytest.raises(ValueError, match="arrival-driven"):
        TB.sweep_suite_makespans(
            [(sc.graph, sc.machine, T.make_scheduler("er_ls"))],
            noise=T.NoiseModel(), seeds=[0], device=CPU)
    row = np.zeros((2, sc.graph.n))
    with pytest.raises(ValueError, match="floors"):
        TB.bucketed_makespans([(sc.graph, plan)], [row], floors=[],
                              device=CPU)
    with pytest.raises(ValueError, match="networks"):
        TB.bucketed_makespans([(sc.graph, plan)], [row], networks=[],
                              device=CPU)
    with pytest.raises(ValueError, match="times must be"):
        TB.batch_makespans(sc.graph, plan, np.zeros(sc.graph.n), device=CPU)
    assert TB.bucketed_makespans([], [], device=CPU) == []


# ------------------------------------------------------------ the kernel's
def test_plain_version_equals_the_jitted_reference_on_random_dags():
    """``bucket_makespans_ref`` against the reference's jitted
    ``_bucket_makespans`` on the same arrays — random DAGs with floors,
    slots of uneven fan-in, S of 1, 31 and 33 — and the kernel's loop
    emulated in numpy float32 against both."""
    rng = np.random.default_rng(4)
    for B, n, P, S in ((3, 9, 4, 1), (2, 12, 5, 31), (4, 7, 3, 33)):
        order = np.zeros((B, n), np.int32)
        pred = np.full((B, n, P), -1, np.int32)
        delay = np.zeros((B, n, P))
        for b in range(B):
            perm = rng.permutation(n).astype(np.int32)
            order[b] = perm
            for i in range(1, n):
                k = rng.integers(0, min(i, P) + 1)
                pred[b, perm[i], :k] = rng.choice(perm[:i], k, replace=False)
                delay[b, perm[i], :k] = rng.uniform(0, 3, k)
        floor = rng.uniform(0, 4, (B, n)) * (rng.random((B, n)) < 0.3)
        times = rng.lognormal(0, 0.5, (B, S, n))
        ref = np.asarray(JB._bucket_makespans(
            JB.BatchedPlanDag(order=jnp.asarray(order), pred=jnp.asarray(pred),
                              pred_mask=jnp.asarray(pred >= 0),
                              pred_delay=jnp.asarray(delay),
                              floor=jnp.asarray(floor),
                              width=jnp.ones((B, n), jnp.int32)),
            jnp.asarray(times)))
        args = (torch.from_numpy(order), torch.from_numpy(pred),
                TB._f32(delay), TB._f32(floor), TB._f32(times))
        got = R.bucket_makespans_ref(*args)
        assert got.dtype == torch.float32 and ref.dtype == np.float32
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(_kernel_emulation(*args), ref)


def test_kernel_emulation_equals_plain_version_on_the_grid_buckets():
    """Every bucket of the suites' grid, floors on, as ``_bucket_makespans``
    hands it to the kernel: phantom slots, chain preds after DAG preds; and
    each again under an order that is not topological."""
    _, _, titems, machines = _grid()
    floors = _floors(titems, [m for _, m in machines],
                     np.random.default_rng(5))
    rows = [TB.sample_actual_batch(g, p, T.NoiseModel("lognormal", 0.2),
                                   [0, 1]) for g, p in titems]
    for key, idxs in TB.bucket_plans(titems).items():
        bd = TB.BatchedPlanDag.from_plans([titems[i] for i in idxs],
                                          floors=[floors[i] for i in idxs])
        tt = TB.bucket_times([rows[i] for i in idxs], bd.n_pad)
        args = (bd.order, bd.pred, bd.pred_delay, bd.floor, tt)
        np.testing.assert_array_equal(_kernel_emulation(*args),
                                      R.bucket_makespans_ref(*args).numpy(),
                                      err_msg=str(key))
        # an order that is not topological and visits a task twice: reads
        # before writes see the zeros, the max sees only the last write
        odd = bd.order.flip(1).clone()
        odd[:, -1] = odd[:, 0]
        args = (odd, bd.pred, bd.pred_delay, bd.floor, tt)
        np.testing.assert_array_equal(_kernel_emulation(*args),
                                      R.bucket_makespans_ref(*args).numpy(),
                                      err_msg=f"{key}, odd order")


def test_wrapper_takes_the_plain_version_on_cpu_and_launch_refuses_it():
    R.reset_launch_count()
    _, _, titems, _ = _grid()
    rows = [TB.sample_actual_batch(g, p, T.NoiseModel("lognormal", 0.2), [0])
            for g, p in titems[:10]]
    TB.bucketed_makespans(titems[:10], rows, device=CPU)
    bd = TB.BatchedPlanDag.from_plans(titems[:1])
    tt = TB.bucket_times(rows[:1], bd.n_pad)
    args = (bd.order, bd.pred, bd.pred_delay, bd.floor, tt)
    assert torch.equal(R.bucket_makespans(*args), R.bucket_makespans_ref(*args))
    assert R.launch_count() == 0
    with pytest.raises(ValueError, match="card"):
        R.launch(*args)
    with pytest.raises(TypeError, match="float32"):
        R.bucket_makespans(bd.order, bd.pred, bd.pred_delay.double(),
                           bd.floor, tt)
    with pytest.raises(ValueError, match="align"):
        R.bucket_makespans(bd.order, bd.pred, bd.pred_delay, bd.floor,
                           tt[:, :, 1:])
    assert R.launch_count() == 0
