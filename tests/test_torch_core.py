"""The port's scheduling core against the JAX package's, bit for bit.

Both packages run the same numpy and scipy (HiGHS) code in one process, so
every array, LP solution, rounding, schedule and decision record must be
identical: any difference is a porting error.  Schedules are compared by
the SHA-256 schedule hash of ``tests/test_sim_golden.py`` (alloc, processor,
start and finish arrays).  Graphs are small (at most 60 tasks).
"""
import dataclasses
import hashlib
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.bruteforce as JB  # noqa: E402
import repro.core.dag as JDag  # noqa: E402
import repro.core.hlp as JH  # noqa: E402
import repro.core.listsched as JL  # noqa: E402
import repro.core.online as JO  # noqa: E402
import repro.core.theory as JT  # noqa: E402
import repro.core.workloads as JW  # noqa: E402
import repro.obs as JObs  # noqa: E402
import repro.platform as JP  # noqa: E402
import repro_torch.core.bruteforce as TB  # noqa: E402
import repro_torch.core.dag as TDag  # noqa: E402
import repro_torch.core.hlp as TH  # noqa: E402
import repro_torch.core.listsched as TL  # noqa: E402
import repro_torch.core.online as TO  # noqa: E402
import repro_torch.core.theory as TT  # noqa: E402
import repro_torch.core.workloads as TW  # noqa: E402
import repro_torch.obs as TObs  # noqa: E402
import repro_torch.platform as TP  # noqa: E402
from repro.sim import scenarios as JS  # noqa: E402
from repro_torch.sim import scenarios as TS  # noqa: E402

# (constructor, args): Chameleon apps in 2 and 3 types, fork-join, and a graph
# with transfer costs on its edges
GRAPHS = {
    "potrf5": ("chameleon", ("potrf", 5, 320)),
    "getrf5_q3": ("chameleon", ("getrf", 4, 64, 3)),
    "posv4": ("chameleon", ("posv", 4, 960)),
    "forkjoin": ("fork_join", (12, 3)),
    "layered_ccr": ("scenario", ("layered", {"n": 40, "layers": 5,
                                             "seed": 2, "ccr": 1.0})),
}
MACHINES_2 = [(8, 2), (16, 4)]


def _graph(mod_w, mod_s, name):
    kind, args = GRAPHS[name]
    if kind == "scenario":
        family, params = args
        return mod_s.make_scenario(family, **params).graph
    return getattr(mod_w, kind)(*args)


def _pair(name):
    return _graph(JW, JS, name), _graph(TW, TS, name)


def _sched_hash(s) -> str:
    h = hashlib.sha256()
    for a in (np.asarray(s.alloc, np.int64), np.asarray(s.proc, np.int64),
              np.asarray(s.start, np.float64),
              np.asarray(s.finish, np.float64)):
        h.update(a.tobytes())
    return h.hexdigest()


def _same_schedule(a, b):
    assert _sched_hash(a) == _sched_hash(b)
    assert a.makespan == b.makespan
    for field in ("width", "procs"):
        va, vb = getattr(a, field), getattr(b, field)
        assert (va is None) == (vb is None)
        if va is not None:
            np.testing.assert_array_equal(np.asarray(va, dtype=object),
                                          np.asarray(vb, dtype=object))


def _decisions(ds):
    return [dataclasses.astuple(d) for d in ds]


def _same_solution(a, b):
    np.testing.assert_array_equal(a.x_frac, b.x_frac)
    np.testing.assert_array_equal(a.alloc, b.alloc)
    assert a.lp_value == b.lp_value and a.status == b.status
    assert (a.width is None) == (b.width is None)
    if a.width is not None:
        np.testing.assert_array_equal(a.width, b.width)


# Tests loop over their cases rather than being parametrized per case: a
# file of many short items changes the order in which pytest-xdist hands
# whole files to its workers, and some of the JAX package's tests count XLA
# compiles in a process whose other files share its jit cache.


# ------------------------------------------------------------ TaskGraph
def test_taskgraph_arrays_equal():
    for name in sorted(GRAPHS):
        jg, tg = _pair(name)
        assert type(tg) is TDag.TaskGraph
        for f in dataclasses.fields(JDag.TaskGraph):
            a, b = getattr(jg, f.name), getattr(tg, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, (name, f.name)
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {f.name}")
            else:
                assert a == b, (name, f.name)
        assert (jg.n, jg.num_types, jg.num_edges, jg.has_comm,
                jg.max_width) == (tg.n, tg.num_types, tg.num_edges,
                                  tg.has_comm, tg.max_width), name


def test_taskgraph_paths_and_bounds_equal():
    for name in sorted(GRAPHS):
        _paths_and_bounds_equal(*_pair(name))


def _paths_and_bounds_equal(jg, tg):
    rng = np.random.default_rng(0)
    alloc = rng.integers(0, jg.num_types, jg.n)
    counts = [8] + [2] * (jg.num_types - 1)
    x = rng.random(jg.n)                  # hybrid CPU share (2 types)
    for q in range(jg.num_types):
        w = jg.proc[:, q]
        assert jg.critical_path(w) == tg.critical_path(w)
        np.testing.assert_array_equal(jg.upward_rank(w), tg.upward_rank(w))
        np.testing.assert_array_equal(jg.earliest_ready(w),
                                      tg.earliest_ready(w))
    np.testing.assert_array_equal(jg.alloc_times(alloc), tg.alloc_times(alloc))
    np.testing.assert_array_equal(jg.edge_delays(alloc), tg.edge_delays(alloc))
    if jg.num_types == 2:
        np.testing.assert_array_equal(jg.frac_times(x), tg.frac_times(x))
        assert jg.lp_objective(counts, x) == tg.lp_objective(counts, x)
    np.testing.assert_array_equal(jg.data_sizes(2.0), tg.data_sizes(2.0))
    np.testing.assert_array_equal(jg.edge_out_ids(), tg.edge_out_ids())
    assert jg.graham_lower_bound(counts, alloc) == \
        tg.graham_lower_bound(counts, alloc)


def test_moldable_curves_equal():
    jg, tg = _pair("potrf5")
    rng = np.random.default_rng(1)
    for curve, lo, hi in (("amdahl", 0.0, 0.5), ("powerlaw", 0.3, 1.0)):
        args = (rng.uniform(lo, hi, jg.n), 4)
        js = getattr(JDag, f"{curve}_speedup")(*args)
        ts = getattr(TDag, f"{curve}_speedup")(*args)
        np.testing.assert_array_equal(js, ts, err_msg=curve)
        jm, tm = jg.with_speedup(js), tg.with_speedup(ts)
        alloc = rng.integers(0, 2, jg.n)
        width = rng.integers(1, 5, jg.n)
        np.testing.assert_array_equal(jm.moldable_times(alloc, width),
                                      tm.moldable_times(alloc, width),
                                      err_msg=curve)
        assert jm.proc_w(3, 1, 3) == tm.proc_w(3, 1, 3), curve
    with pytest.raises(ValueError):
        TDag.validate_speedup(np.zeros((tg.n, 2)), tg.n)


# ------------------------------------------------------------ allocation
@pytest.mark.parametrize("m,k", MACHINES_2)
def test_hlp_solutions_equal(m, k):
    for name in ("potrf5", "posv4", "forkjoin", "layered_ccr"):
        jg, tg = _pair(name)
        for canonical in (False, True):
            _same_solution(JH.solve_hlp(jg, m, k, canonical=canonical),
                           TH.solve_hlp(tg, m, k, canonical=canonical))


def test_qhlp_solutions_equal():
    jg, tg = _pair("getrf5_q3")
    for counts in ([8, 2, 2], [16, 4, 2]):
        _same_solution(JH.solve_qhlp(jg, counts), TH.solve_qhlp(tg, counts))
        assert JH.lp_lower_bound(jg, counts) == TH.lp_lower_bound(tg, counts)


def test_mhlp_solutions_and_rounding_equal():
    jsc = JS.moldable_suite(seed=0, num=1)[0]
    tsc = TS.moldable_suite(seed=0, num=1)[0]
    assert JH.mhlp_choices(jsc.graph, jsc.machine.counts) == \
        TH.mhlp_choices(tsc.graph, tsc.machine.counts)
    for canonical in (False, True):
        js = JH.solve_mhlp(jsc.graph, jsc.machine, canonical=canonical)
        ts = TH.solve_mhlp(tsc.graph, tsc.machine, canonical=canonical)
        _same_solution(js, ts)
        assert _decisions(js.decisions) == _decisions(ts.decisions)
        ja, wa = JH.canonical_round_moldable(jsc.graph, jsc.machine, js.x_frac)
        ta, wt = TH.canonical_round_moldable(tsc.graph, tsc.machine, ts.x_frac)
        np.testing.assert_array_equal(ja, ta)
        np.testing.assert_array_equal(wa, wt)


# ------------------------------------------------------- list scheduling
@pytest.mark.parametrize("m,k", MACHINES_2)
def test_est_ols_heft_schedules_equal(m, k):
    for name in ("potrf5", "posv4", "forkjoin", "layered_ccr"):
        _list_schedules_equal(*_pair(name), m, k)


def _list_schedules_equal(jg, tg, m, k):
    alloc = JH.solve_hlp(jg, m, k).alloc
    _same_schedule(JL.hlp_est(jg, [m, k], alloc), TL.hlp_est(tg, [m, k], alloc))
    _same_schedule(JL.hlp_ols(jg, [m, k], alloc), TL.hlp_ols(tg, [m, k], alloc))
    np.testing.assert_array_equal(JL.ols_rank(jg, alloc), TL.ols_rank(tg, alloc))
    for comm_aware in (True, False):
        _same_schedule(JL.heft(jg, [m, k], comm_aware=comm_aware),
                       TL.heft(tg, [m, k], comm_aware=comm_aware))
    TL.hlp_ols(tg, TP.Platform.hybrid(m, k), alloc).validate(tg, [m, k])


def test_three_type_schedules_equal():
    jg, tg = _pair("getrf5_q3")
    for counts in ([8, 2, 2], [16, 4, 2]):
        alloc = JH.solve_qhlp(jg, counts).alloc
        _same_schedule(JL.hlp_ols(jg, counts, alloc),
                       TL.hlp_ols(tg, counts, alloc))
        _same_schedule(JL.heft(jg, counts), TL.heft(tg, counts))


# --------------------------------------------------------------- on-line
@pytest.mark.parametrize("m,k", MACHINES_2)
def test_online_schedules_equal(m, k):
    for name in ("potrf5", "forkjoin", "layered_ccr"):
        _online_schedules_equal(name, *_pair(name), m, k)


def _online_schedules_equal(name, jg, tg, m, k):
    order = np.random.default_rng(m + k).permutation(jg.topo)
    order = jg.topo if name == "layered_ccr" else order[np.argsort(
        jg.level[order], kind="stable")]
    _same_schedule(JO.er_ls(jg, [m, k]), TO.er_ls(tg, [m, k]))
    _same_schedule(JO.er_ls(jg, [m, k], order), TO.er_ls(tg, [m, k], order))
    _same_schedule(JO.eft_online(jg, [m, k]), TO.eft_online(tg, [m, k]))
    for rule in JO.RULES:
        _same_schedule(JO.greedy_online(jg, [m, k], rule),
                       TO.greedy_online(tg, [m, k], rule))
    _same_schedule(JO.random_online(jg, [m, k], seed=3),
                   TO.random_online(tg, [m, k], seed=3))


def test_online_decisions_and_records_equal():
    jg, tg = _pair("potrf5")
    with JObs.capture() as jcap:
        JO.er_ls(jg, [8, 2])
    with TObs.capture() as tcap:
        TO.er_ls(tg, [8, 2])
    jrec = [dataclasses.astuple(r) for r in jcap.decisions]
    trec = [dataclasses.astuple(r) for r in tcap.decisions]
    assert jrec and jrec == trec
    jstate = JP.Platform.hybrid(8, 2).state()
    tstate = TP.Platform.hybrid(8, 2).state()
    ready = np.array([0.0, 0.5])
    for j in range(jg.n):
        assert JO.decide_erls(jg, j, 8, 2, ready, jstate) == \
            TO.decide_erls(tg, j, 8, 2, ready, tstate)
        assert JO.decide_eft(jg, j, [8, 2], ready, jstate) == \
            TO.decide_eft(tg, j, [8, 2], ready, tstate)
        jstate.commit(0, 0.0, float(jg.proc[j, 0]))
        tstate.commit(0, 0.0, float(tg.proc[j, 0]))


# --------------------------------------------------- theory, brute force
def test_theory_constructions_and_bounds_equal():
    for m, k in ((4, 2), (9, 3)):
        for fn in ("heft_worstcase_bound", "erls_optimal_makespan",
                   "erls_competitive_bound"):
            assert getattr(JT, fn)(m, k) == getattr(TT, fn)(m, k), fn
        for fn in ("hlp_worstcase_lp_value", "hlp_worstcase_makespan"):
            assert getattr(JT, fn)(m) == getattr(TT, fn)(m), fn
        np.testing.assert_array_equal(JT.hlp_worstcase_fractional(m),
                                      TT.hlp_worstcase_fractional(m))
        jg, tg = JT.heft_worstcase(m, k), TT.heft_worstcase(m, k)
        np.testing.assert_array_equal(jg.proc, tg.proc)
        _same_schedule(JL.heft(jg, [m, k]), TL.heft(tg, [m, k]))
        (jg, jo), (tg, to) = JT.erls_worstcase(m, k), TT.erls_worstcase(m, k)
        np.testing.assert_array_equal(jo, to)
        _same_schedule(JO.er_ls(jg, [m, k], jo), TO.er_ls(tg, [m, k], to))
    for name in ("potrf5", "forkjoin"):
        jg, tg = _pair(name)
        assert JT.makespan_lower_bound(jg, [8, 2]) == \
            TT.makespan_lower_bound(tg, [8, 2]), name
        assert JT.ratio_denominator(jg, [8, 2]) == \
            TT.ratio_denominator(tg, [8, 2]), name


def test_brute_force_equal():
    jsc = JS.random_scenario(n=8, seed=7, counts=(3, 2))
    tsc = TS.random_scenario(n=8, seed=7, counts=(3, 2))
    assert JB.brute_force_opt(jsc.graph, jsc.machine) == \
        TB.brute_force_opt(tsc.graph, tsc.machine)
    _same_schedule(JB.brute_force_schedule(jsc.graph, jsc.machine),
                   TB.brute_force_schedule(tsc.graph, tsc.machine))


# -------------------------------------------------------------- platform
def test_platform_helpers_equal():
    assert sorted(JP.PLATFORMS) == sorted(TP.PLATFORMS)
    for name in JP.PLATFORMS:
        assert JP.PLATFORMS[name].counts == TP.PLATFORMS[name].counts
    alloc, width = np.array([0, 1, 1, 0]), np.array([1, 2, 1, 3])
    jd, td = JP.decisions_of(alloc, width), TP.decisions_of(alloc, width)
    assert _decisions(jd) == _decisions(td)
    for a, b in zip(JP.pack_decisions(jd), TP.pack_decisions(td)):
        np.testing.assert_array_equal(a, b)
    TP._reset_deprecation_registry()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert TP.as_platform([8, 2]) == TP.Platform.hybrid(8, 2)
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert TP.as_platform([8, 2], warn=False).counts == (8, 2)
