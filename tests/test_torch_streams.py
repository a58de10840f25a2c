"""The port's open-system streams (``repro_torch.streams``) against the JAX
package's ``repro.streams``.

The same seeds go through both packages on the CPU and everything is
compared with ``==``: arrival times, job bodies, ESTEE replays, every task
and job record of ``run_stream`` for every adapter policy on Poisson, MMPP
and closed-loop streams, a contended ``maxmin_fair`` run with its transfer
log, ``SimInTheLoop``'s decisions (its rollouts through the replay
evaluator's plain version, float32 makespans equal to the reference's), its
budget fallback and its trace count, and the metrics and trace events of a
run.  The rollouts on the card: ``tests/test_torch_streams_card.py``.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs.trace as JT  # noqa: E402
import repro.sim as JSIM  # noqa: E402
import repro.sim.batch as JB  # noqa: E402
import repro.streams as J  # noqa: E402
import repro.streams.metrics as JM  # noqa: E402
import repro_torch.obs.trace as TT  # noqa: E402
import repro_torch.sim as TSIM  # noqa: E402
import repro_torch.sim.batch as TB  # noqa: E402
import repro_torch.streams as T  # noqa: E402
import repro_torch.streams.metrics as TM  # noqa: E402
from repro.sim.engine import Machine as JMachine  # noqa: E402
from repro_torch.sim.engine import Machine as TMachine  # noqa: E402
from repro_torch.streams.policy import conditioned_plan  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "estee_trace.json")
POLICIES = ["er_ls", "eft", "greedy_r2", "heft", "random"]
FAMILIES = ("fork_join", "layered", "random")


def _machines(m=4, k=2):
    return JMachine.hybrid(m, k), TMachine.hybrid(m, k)


def _source(pkg, kind, seed=0, num_jobs=8, families=FAMILIES):
    fac = pkg.JobFactory(families)
    if kind == "poisson":
        return pkg.open_stream(pkg.PoissonProcess(0.08), fac,
                               num_jobs=num_jobs, num_tenants=3, seed=seed)
    if kind == "mmpp":
        return pkg.open_stream(pkg.MMPPProcess(rates=(0.04, 0.6),
                                               dwell=(60.0, 25.0)), fac,
                               num_jobs=num_jobs, num_tenants=3, seed=seed)
    return pkg.ClosedLoopSource(fac, num_tenants=3, think=6.0,
                                jobs_per_tenant=3, seed=seed)


def _job(j):
    g = j.graph
    return (j.jid, j.tenant, j.arrival, j.name, g.proc.tobytes(),
            np.asarray(g.edges).tobytes(), np.asarray(g.comm).tobytes(),
            None if g.speedup is None else g.speedup.tobytes())


def _records(res):
    return ([dataclasses.astuple(t) for t in res.tasks],
            [dataclasses.astuple(j) for j in res.jobs], res.horizon,
            res.policy, [tuple(x) for x in res.transfers])


def _same_run(a, b, what):
    ra, rb = _records(a), _records(b)
    for part, x, y in zip(("tasks", "jobs", "horizon", "policy",
                           "transfers"), ra, rb):
        assert x == y, f"{what}: {part} differ"


def test_arrival_processes_draw_the_references_times():
    for seed in (0, 7, 123):
        for jp, tp in ((J.PoissonProcess(0.06), T.PoissonProcess(0.06)),
                       (J.MMPPProcess((0.04, 0.6), (60.0, 25.0)),
                        T.MMPPProcess((0.04, 0.6), (60.0, 25.0)))):
            a = jp.arrival_times(200, np.random.default_rng(seed))
            b = tp.arrival_times(200, np.random.default_rng(seed))
            assert a.tobytes() == b.tobytes(), (jp.name, seed)
    assert T.DEFAULT_JOB_PARAMS == J.DEFAULT_JOB_PARAMS


def test_sources_release_the_references_jobs():
    """``open_stream`` over both processes and every family,
    ``ClosedLoopSource`` (its initial jobs and the jobs it submits on
    completion) and ``chameleon_stream``: the same job bodies."""
    fams = ("chain", "fork_join", "layered", "random", "netbound",
            "cholesky", "lu", "moldable_cholesky")
    for kind in ("poisson", "mmpp"):
        a = _source(J, kind, seed=3, num_jobs=12, families=fams)
        b = _source(T, kind, seed=3, num_jobs=12, families=fams)
        assert [_job(j) for j in a.initial_jobs()] == \
            [_job(j) for j in b.initial_jobs()]
    a, b = _source(J, "closed", seed=2), _source(T, "closed", seed=2)
    assert [_job(j) for j in a.initial_jobs()] == \
        [_job(j) for j in b.initial_jobs()]
    for job_a, job_b in zip(a.initial_jobs(), b.initial_jobs()):
        assert _job(a.on_job_complete(job_a, 50.0)) == \
            _job(b.on_job_complete(job_b, 50.0))
    for kw in ({}, {"apps": ("potrf", "getrf", "potri"), "num_jobs": 5,
                    "nb_blocks": (4, 6), "ccr": 0.5, "seed": 11}):
        assert [_job(j) for j in J.chameleon_stream(**kw).initial_jobs()] \
            == [_job(j) for j in T.chameleon_stream(**kw).initial_jobs()]


def test_estee_replay_releases_the_references_jobs():
    for kw in ({"arrivals": [0.0, 10.0, 20.0]}, {"rate": 0.2, "seed": 4},
               {"num_tenants": 2, "seed": 1}):
        a = J.replay_estee([FIXTURE] * 3, **kw)
        b = T.replay_estee([FIXTURE] * 3, **kw)
        assert [_job(j) for j in a.initial_jobs()] == \
            [_job(j) for j in b.initial_jobs()]


@pytest.mark.parametrize("kind", ["poisson", "mmpp", "closed"])
def test_every_adapter_policy_commits_the_references_records(kind):
    """``run_stream`` under lognormal noise: every task record (type,
    processor, units, arrival, start, finish) and job record (busy area,
    reference bound) equal, for each adapter policy; closed-loop sources
    feed completions back, so each policy gets its own source."""
    jm, tm = _machines()
    noise_j, noise_t = (JSIM.NoiseModel("lognormal", 0.2),
                        TSIM.NoiseModel("lognormal", 0.2))
    for name in POLICIES:
        a = J.run_stream(_source(J, kind, seed=1), jm, J.make_policy(name),
                         noise=noise_j, seed=1)
        b = T.run_stream(_source(T, kind, seed=1), tm,
                         T.make_policy(name, device="cpu"), noise=noise_t,
                         seed=1)
        assert len(b.jobs) == (9 if kind == "closed" else 8)
        _same_run(a, b, f"{kind}/{name}")
        assert a.mean_slowdown() == b.mean_slowdown()


def test_network_models_run_the_references_streams():
    """A non-contended network (``fixed_latency``: each job's effective
    comm) and a contended one (``maxmin_fair``: the shared host
    ``TransferTracker`` with output caching) on an ESTEE replay with sized
    data objects: the same records and, with the obs registries enabled
    (which keep the tracker's log), the same transfer log."""
    import repro.obs as jobs
    import repro_torch.obs as tobs
    jm, tm = _machines()
    jobs.enable()
    tobs.enable()
    try:
        for jnet, tnet in ((JSIM.FixedLatencyNetwork(),
                            TSIM.FixedLatencyNetwork()),
                           (JSIM.MaxMinFairNetwork(),
                            TSIM.MaxMinFairNetwork())):
            args = dict(arrivals=[0.0, 1.0, 2.0], seed=0)
            for name in ("heft", "random"):   # random crosses the types
                a = J.run_stream(J.replay_estee([FIXTURE] * 3, **args), jm,
                                 J.make_policy(name), seed=0, network=jnet)
                b = T.run_stream(T.replay_estee([FIXTURE] * 3, **args), tm,
                                 T.make_policy(name, device="cpu"), seed=0,
                                 network=tnet)
                _same_run(a, b, f"{jnet.name}/{name}")
                assert (len(b.transfers) > 0) == (jnet.contended
                                                  and name == "random")
    finally:
        jobs.disable()
        tobs.disable()


def test_sim_in_the_loop_makes_the_references_decisions(monkeypatch):
    """``SimInTheLoop`` with noisy rollouts at three seeds, on a bursty
    stream: every arrival's rollout makespans (each candidate's float32
    makespan at each seed) are the reference's bit for bit, so each argmin
    over the candidates' means picks the reference's candidate, and the
    decisions and every record are equal."""
    import repro.streams.policy as JP
    import repro_torch.streams.policy as TP
    kept = {}
    for name, mod in (("ref", JP), ("port", TP)):
        kept[name] = []

        def sweep(*args, _fn=mod.sweep_suite_makespans, _to=kept[name],
                  **kw):
            out = _fn(*args, **kw)
            _to.append([np.asarray(s, np.float32).tobytes() for s in out])
            return out
        monkeypatch.setattr(mod, "sweep_suite_makespans", sweep)
    jm, tm = _machines(8, 2)
    kw = dict(rollout_seeds=range(3))
    a_pol = J.SimInTheLoop(rollout_noise=JSIM.NoiseModel("lognormal", 0.2),
                           **kw)
    b_pol = T.SimInTheLoop(rollout_noise=TSIM.NoiseModel("lognormal", 0.2),
                           device="cpu", **kw)
    a = J.run_stream(_source(J, "mmpp", seed=0, num_jobs=10), jm, a_pol,
                     noise=JSIM.NoiseModel("lognormal", 0.2), seed=0)
    b = T.run_stream(_source(T, "mmpp", seed=0, num_jobs=10), tm, b_pol,
                     noise=TSIM.NoiseModel("lognormal", 0.2), seed=0)
    assert len(kept["port"]) == len(b_pol.decisions) == 10
    assert kept["port"] == kept["ref"]
    assert b_pol.decisions == a_pol.decisions
    assert len({c for _, c in b_pol.decisions}) >= 2
    _same_run(a, b, "sim_in_the_loop")


def test_sim_in_the_loop_candidates_and_floors():
    """Per job, the conditioned plans and rollout makespans of every
    candidate against a busy backlog equal the reference's, with the
    comm-aware candidate set on a job with edge costs."""
    from repro.streams.policy import conditioned_plan as jconditioned
    jm, tm = _machines()
    jobs_j, jobs_t = [pkg.open_stream(
        pkg.PoissonProcess(0.08), pkg.JobFactory(("netbound",), ccr=1.0),
        num_jobs=3, seed=6).initial_jobs() for pkg in (J, T)]
    busy = [np.array([3.0, 9.5, 0.0, 1.25]), np.array([7.0, 2.0])]
    for ja, tb in zip(jobs_j, jobs_t):
        assert tb.graph.has_comm
        for c in T.COMM_CANDIDATES:
            pa = jconditioned(c, ja.graph, jm, busy, 2.0)
            pb = conditioned_plan(c, tb.graph, tm, busy, 2.0)
            assert (pa.alloc.tobytes(), pa.sequences) == \
                (pb.alloc.tobytes(), pb.sequences), c
            fa = JB.rollout_floors(ja.graph, pa, busy, now=2.0)
            fb = TB.rollout_floors(tb.graph, pb, busy, now=2.0)
            assert fa.tobytes() == fb.tobytes()
            sa = JB.sweep_suite_makespans(
                [(ja.graph, jm, JSIM.adapters.FrozenPlanScheduler(pa))],
                noise=JSIM.NoiseModel("lognormal", 0.2), seeds=[0, 1],
                floor_fn=lambda g, p: fa, envelope=True)
            sb = TB.sweep_suite_makespans(
                [(tb.graph, tm, TSIM.adapters.FrozenPlanScheduler(pb))],
                noise=TSIM.NoiseModel("lognormal", 0.2), seeds=[0, 1],
                floor_fn=lambda g, p: fb, envelope=True, device="cpu")
            assert np.asarray(sa[0]).tobytes() == sb[0].tobytes(), c


def test_sim_in_the_loop_budget_falls_back_to_erls():
    """A zero budget: the first rollout is warmup, the second records the
    cost, every later job takes the ER-LS fallback, as in the reference."""
    jm, tm = _machines()
    a_pol, b_pol = J.SimInTheLoop(budget_s=0.0), T.SimInTheLoop(
        budget_s=0.0, device="cpu")
    a = J.run_stream(_source(J, "poisson", seed=2, num_jobs=5), jm, a_pol,
                     seed=0)
    b = T.run_stream(_source(T, "poisson", seed=2, num_jobs=5), tm, b_pol,
                     seed=0)
    labels = [c for _, c in b_pol.decisions]
    assert labels[0] in b_pol.candidates and labels[1] in b_pol.candidates
    assert labels[2:] == ["fallback:er_ls"] * 3
    assert b_pol.decisions == a_pol.decisions
    _same_run(a, b, "sitl with a zero budget")


def test_sim_in_the_loop_replays_one_shape_per_bucket():
    """Six chain jobs of one length land in one shape bucket: a whole
    stream's rollouts replay at most one new shape (the reference's rule of
    at most one XLA trace per bucket)."""
    _, tm = _machines()
    pol = T.SimInTheLoop(device="cpu")
    TB.reset_trace_counts()
    res = T.run_stream(_source(T, "poisson", seed=5, num_jobs=6,
                               families=("chain",)), tm, pol, seed=0)
    keys = set()
    for job in _source(T, "poisson", seed=5, num_jobs=6,
                       families=("chain",)).initial_jobs():
        busy = [np.zeros(c) for c in tm.counts]
        plan = conditioned_plan("er_ls", job.graph, tm, busy, 0.0)
        keys |= set(TB.bucket_plans([(job.graph, plan)]))
    assert len(keys) == 1
    assert TB.trace_count("bucket") <= len(keys)
    assert len(pol.decisions) == 6
    assert (res.slowdowns() >= 1.0).all()


def test_metrics_and_trace_events_are_the_references():
    """``utilization`` (active span and a fixed horizon),
    ``queue_length_series``, ``mean_queue_length``, the tenant table and
    ``stream_trace_events`` of one run, in both packages."""
    jm, tm = _machines()
    a = J.run_stream(J.replay_estee([FIXTURE] * 3, arrivals=[1e3, 1e3 + 5,
                                                            1e3 + 9], seed=0),
                     jm, J.make_policy("heft"), seed=0,
                     network=JSIM.MaxMinFairNetwork())
    b = T.run_stream(T.replay_estee([FIXTURE] * 3, arrivals=[1e3, 1e3 + 5,
                                                            1e3 + 9], seed=0),
                     tm, T.make_policy("heft", device="cpu"), seed=0,
                     network=TSIM.MaxMinFairNetwork())
    assert a.utilization().tobytes() == b.utilization().tobytes()
    assert JM.utilization(a.tasks, jm, horizon=1e6).tobytes() == \
        TM.utilization(b.tasks, tm, horizon=1e6).tobytes()
    for x, y in zip(JM.queue_length_series(a.tasks),
                    TM.queue_length_series(b.tasks)):
        assert x.tobytes() == y.tobytes()
    assert a.mean_queue_length() == b.mean_queue_length() > 0
    assert a.tenant_table() == b.tenant_table()
    assert a.slowdowns().tobytes() == b.slowdowns().tobytes()
    assert JT.stream_trace_events(a) == TT.stream_trace_events(b)
    assert TM.queue_length_series([])[0].size == 0
    assert TM.mean_queue_length([]) == 0.0


def test_package_exports_the_references_names():
    assert T.__all__ == J.__all__
    for name in T.__all__:
        assert getattr(T, name) is not None, name
    assert T.DEFAULT_CANDIDATES == J.DEFAULT_CANDIDATES
    assert T.COMM_CANDIDATES == J.COMM_CANDIDATES
    assert T.SEARCH_CANDIDATES == J.SEARCH_CANDIDATES
