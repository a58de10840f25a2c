"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``.

The registry's gauges, ``timer``, ``Span.elapsed``, ``wall_events`` and
``snapshot``; the chrome-trace export (simulated task lanes, transfer link
lanes, stream lanes, wall-clock lanes, the export/load round trip and the
loader's key check); and the provenance readers (``provenance_diff``,
``explain_divergence``, ``dump_decisions``): each is fed the same inputs
in both packages and must give the same output.  The port's engine and
allocators are bit-equal to the reference's (``tests/test_torch_sim.py``),
so simulated lanes and decision records compare exactly.
"""
import json
import os

import pytest

pytest.importorskip("torch")

import repro.sim as J  # noqa: E402
import repro.sim.scenarios as JS  # noqa: E402
import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.scenarios as TS  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro_torch import obs  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "estee_trace.json")


@pytest.fixture(autouse=True)
def _registries_off():
    """Every test starts and ends with both registries disabled and clean."""
    for reg in (obs, jobs):
        reg.disable()
        reg.reset(counters=True)
    yield
    for reg in (obs, jobs):
        reg.disable()
        reg.reset(counters=True)


def _without_times(events):
    """Wall events with their clock readings dropped (they differ run to
    run); everything else must match."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


# ------------------------------------------------------------------ registry
def test_gauges_timer_and_snapshot_match_the_reference():
    for reg in (obs, jobs):
        assert not reg.enabled()
        reg.bump("a.b", 2)
        reg.set_gauge("g.x", 1.5)
        reg.set_gauge("g.x", 2.5)
        with reg.timer("bench.phase", n=3) as sp:
            assert sp.elapsed() >= 0.0
        assert sp.dur > 0.0 and reg.wall_events() == []
    assert obs.gauges() == jobs.gauges() == {"g.x": 2.5}
    assert obs.snapshot() == jobs.snapshot() == {
        "enabled": False, "counters": {"a.b": 2}, "gauges": {"g.x": 2.5},
        "spans": 0, "decisions": 0}
    for reg in (obs, jobs):
        with reg.capture():
            with reg.timer("bench.phase", n=3):
                pass
            with reg.span("lp.solve"):
                pass
            assert reg.snapshot()["enabled"] and reg.snapshot()["spans"] == 2
    assert _without_times(obs.wall_events()) == _without_times(
        jobs.wall_events())
    obs.reset(counters=True)
    assert obs.gauges() == {} and obs.counters() == {}


def test_span_is_a_noop_singleton_while_disabled():
    a, b = obs.span("x"), obs.span("y", k=1)
    assert a is b and a.dur == 0.0
    with a:
        pass
    assert obs.wall_events() == []
    with obs.capture():
        sp = obs.span("lp.solve", n=1)
        assert sp is not a
        with sp:
            pass
    assert obs.wall_events()[0]["args"] == {"n": 1}


# ------------------------------------------------------------- chrome traces
def test_wall_trace_lanes_equal_the_reference():
    for reg in (obs, jobs):
        with reg.capture():
            for name in ("lp.solve", "lp.canonical_round", "sim.execute",
                         "sim.pipeline.build", "sim.pipeline.drain"):
                with reg.span(name, plans=2):
                    pass
    got, want = obs.wall_trace_events(), jobs.wall_trace_events()
    assert _without_times(got) == _without_times(want)
    lanes = {e["args"]["name"]: e["tid"] for e in got
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert set(lanes) == {"lp", "sim"}
    # the same events handed in explicitly
    events = jobs.wall_events()
    assert obs.wall_trace_events(events) == jobs.wall_trace_events(events)


def test_sim_and_transfer_lanes_equal_the_reference():
    """Task lanes of the same simulation in both packages (a comm scenario
    under ``maxmin_fair``, whose transfers get link lanes)."""
    for name in ("hlp_ols", "heft"):
        ts, js = TS.netbound_scenario(seed=300), JS.netbound_scenario(seed=300)
        tr = T.simulate(ts.graph, ts.machine, T.make_scheduler(name),
                        network=T.make_network("maxmin_fair"))
        jr = J.simulate(js.graph, js.machine, J.make_scheduler(name),
                        network=J.make_network("maxmin_fair"))
        assert obs.sim_trace_events(tr, ts.machine) == \
            jobs.sim_trace_events(jr, js.machine)
    transfers = [(0.5, 1.25, (("up", 0), ("down", 1)), 7.0),
                 (1.0, 2.0, (("up", 1), ("down", 0)), 9.0)]
    assert obs.transfer_trace_events(transfers, [3, 2]) == \
        jobs.transfer_trace_events(transfers, [3, 2])


def test_stream_lanes_equal_the_reference():
    """A contended multi-tenant stream of the reference (the port's
    streams engine is ROADMAP A8): the port's exporter gives the same
    task and link lanes."""
    from repro.sim import MaxMinFairNetwork
    from repro.sim.engine import Machine
    from repro.streams import make_policy, replay_estee, run_stream

    src = replay_estee([FIXTURE] * 2, arrivals=[0.0, 1.0], seed=0)
    with jobs.capture():
        res = run_stream(src, Machine.hybrid(4, 2), make_policy("random"),
                         seed=0, network=MaxMinFairNetwork())
    assert res.transfers
    got = obs.stream_trace_events(res)
    assert got == jobs.stream_trace_events(res)
    assert {e["cat"] for e in got if e["ph"] == "X"} == {"task", "transfer"}


def test_export_load_round_trip_both_ways(tmp_path):
    sc = TS.default_suite(seed=0)[1]
    res = T.simulate(sc.graph, sc.machine, T.make_scheduler("hlp_ols"))
    with obs.capture():
        with obs.span("lp.solve"):
            pass
        events = obs.sim_trace_events(res, sc.machine) + \
            obs.wall_trace_events()
    ours = obs.export_chrome_trace(str(tmp_path / "t.json"), events)
    theirs = jobs.export_chrome_trace(str(tmp_path / "j.json"), events)
    assert ours == str(tmp_path / "t.json")
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    loaded = obs.load_chrome_trace(ours)
    assert loaded == jobs.load_chrome_trace(theirs) == events
    assert "traceEvents" in json.loads((tmp_path / "t.json").read_text())
    assert obs.CHROME_REQUIRED_KEYS == jobs.CHROME_REQUIRED_KEYS


def test_loader_rejects_events_missing_required_keys(tmp_path):
    path = os.path.join(tmp_path, "bad.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": [{"ph": "X", "ts": 0, "name": "t"}]}, f)
    with pytest.raises(ValueError, match="pid"):
        obs.load_chrome_trace(path)


# --------------------------------------------------------------- provenance
def test_dump_decisions_equals_the_reference(tmp_path):
    """The LP allocator's and ER-LS's records of the same graph, dumped by
    both packages: the same JSON."""
    paths = {}
    for mod, scen, reg, tag in ((T, TS, obs, "t"), (J, JS, jobs, "j")):
        sc = scen.default_suite(seed=0)[2]
        with reg.capture():
            mod.make_scheduler("hlp_ols").allocate(sc.graph, sc.machine)
            mod.simulate(sc.graph, sc.machine, mod.make_scheduler("er_ls"))
            paths[tag] = reg.dump_decisions(str(tmp_path / f"{tag}.json"))
    got = json.loads(open(paths["t"]).read())
    assert got == json.loads(open(paths["j"]).read())
    assert {r["scheduler"] for r in got} == {"hlp_ols", "er_ls"}


def test_explain_divergence_on_netbound_equals_the_reference():
    ts, js = TS.netbound_scenario(seed=300), JS.netbound_scenario(seed=300)
    got = obs.explain_divergence(ts.graph, ts.machine, "cahlp_ols", "hlp_ols")
    want = jobs.explain_divergence(js.graph, js.machine, "cahlp_ols",
                                   "hlp_ols")
    assert got and json.dumps(got) == json.dumps(want)
    assert any("comm paid" in d["why"] for d in got)
    assert not obs.enabled()


def test_provenance_diff_pairs_tasks_and_skips_agreement():
    sc = TS.netbound_scenario(seed=301)
    with obs.capture():
        T.make_scheduler("cahlp_ols").allocate(sc.graph, sc.machine)
        T.make_scheduler("hlp_ols").allocate(sc.graph, sc.machine)
        a = obs.decision_records("cahlp_ols")
        b = obs.decision_records("hlp_ols")
    assert obs.provenance_diff(a, a) == []
    diff = obs.provenance_diff(a, b)
    assert [d["task"] for d in diff] == sorted(d["task"] for d in diff)
    for d in diff:
        assert (d["a"]["rtype"], d["a"]["width"]) != (d["b"]["rtype"],
                                                      d["b"]["width"])
    assert json.dumps(diff) == json.dumps(jobs.provenance_diff(
        [jobs.DecisionRecord(**r.to_dict()) for r in a],
        [jobs.DecisionRecord(**r.to_dict()) for r in b]))
