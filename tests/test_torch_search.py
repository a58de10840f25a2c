"""The port's plan search (``repro_torch.search``) against the JAX package's.

Seeded GA, CEM and SA runs must hand back the reference's ``SearchResult``
exactly: the best-so-far history, the fitness, the generation-0 best, the
heuristic seeds' fitness, the evals, the cache hits and the winning genome.
Every fitness is a float32 replay the port computes bit for bit as the
reference does, so the numpy ``Generator``s of both runs draw the same
streams.  The reference side runs in a subprocess: a reference search in a
pytest worker would warm the jit shape that
``tests/test_search.py::test_whole_search_is_one_xla_compile`` counts
(ROADMAP C4).  The rest of the file holds the port to the invariants of
``tests/test_search.py``: generation-0 dominance, the oracle at small n,
one replay shape per search, reproducibility, the genome round trip, the
fixed envelope, the ``evo`` adapters through the pipelined sweep, and the
obs counters.  Everything is scored on the CPU (``device="cpu"``, the plain
replay).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.sim as T  # noqa: E402
import repro_torch.sim.batch as TB  # noqa: E402
import repro_torch.sim.pipeline as TP  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.search import (Genome, SearchConfig, evolve_plan,  # noqa: E402
                                genome_to_plan, plan_to_genome, random_genome,
                                seed_plans)
from repro_torch.sim.engine import plan_times  # noqa: E402
from repro_torch.sim.scenarios import (default_suite,  # noqa: E402
                                       layered_scenario,
                                       moldable_cholesky_scenario,
                                       random_scenario)

CPU = "cpu"
SRC = Path(__file__).resolve().parents[1] / "src"

# (scenario generator, its kwargs, SearchConfig kwargs, search seed)
CASES = [
    ("layered_scenario", {"n": 30, "layers": 5, "seed": 3, "ccr": 1.0},
     {"method": "ga", "pop_size": 12, "generations": 4, "comm_aware": True},
     2),
    ("layered_scenario", {"n": 30, "layers": 5, "seed": 3, "ccr": 1.0},
     {"method": "cem", "pop_size": 12, "generations": 4, "comm_aware": True},
     2),
    ("layered_scenario", {"n": 30, "layers": 5, "seed": 3, "ccr": 1.0},
     {"method": "sa", "pop_size": 12, "generations": 4, "comm_aware": True},
     2),
    ("random_scenario", {"n": 20, "seed": 9},
     {"method": "ga", "pop_size": 10, "generations": 3}, 5),
    ("moldable_cholesky_scenario", {"nb_blocks": 3, "seed": 4},
     {"method": "ga", "pop_size": 10, "generations": 3}, 1),
    ("moldable_cholesky_scenario", {"nb_blocks": 3, "seed": 4},
     {"method": "cem", "pop_size": 10, "generations": 3}, 1),
]

_REFERENCE = """
import json, sys
import repro.sim.scenarios as S
from repro.search import SearchConfig, evolve_plan
from repro.sim.pipeline import plan_fingerprint

out = []
for gen, kw, cfg, seed in json.loads(sys.argv[1]):
    sc = getattr(S, gen)(**kw)
    r = evolve_plan(sc.graph, sc.machine, SearchConfig(**cfg), seed=seed)
    out.append({"history": r.history, "fitness": r.fitness,
                "gen0_best": r.gen0_best, "seed_fitness": r.seed_fitness,
                "evals": r.evals, "cache_hits": r.cache_hits,
                "method": r.method, "types": r.genome.types.tolist(),
                "widths": r.genome.widths.tolist(),
                "perm": r.genome.perm.tolist(),
                "plan": plan_fingerprint(r.plan)})
print(json.dumps(out))
"""


def _result(r) -> dict:
    return {"history": r.history, "fitness": r.fitness,
            "gen0_best": r.gen0_best, "seed_fitness": r.seed_fitness,
            "evals": r.evals, "cache_hits": r.cache_hits, "method": r.method,
            "types": r.genome.types.tolist(),
            "widths": r.genome.widths.tolist(),
            "perm": r.genome.perm.tolist(),
            "plan": TP.plan_fingerprint(r.plan)}


def test_seeded_searches_equal_the_reference():
    """GA / CEM / SA on a communication-bound layered graph (comm-aware
    seeds and tie-break), GA on a random graph, GA and CEM on a moldable
    Cholesky (widths in the genome): every field equal, floats exactly."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _REFERENCE,
                           json.dumps(CASES)], capture_output=True, text=True,
                          env=env, timeout=600, check=True)
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    import repro_torch.sim.scenarios as S
    got = []
    for gen, kw, cfg, seed in CASES:
        sc = getattr(S, gen)(**kw)
        got.append(_result(evolve_plan(sc.graph, sc.machine,
                                       SearchConfig(**cfg), seed=seed,
                                       device=CPU)))
    # the JSON round trip keeps every float64 exactly
    got = json.loads(json.dumps(got))
    assert any(max(w) > 1 for w in (g["widths"] for g in got))
    for case, g, w in zip(CASES, got, want):
        assert g == w, case
        assert len(g["history"]) == case[2]["generations"] + 1


def test_gen0_best_dominates_the_heuristic_seeds():
    for sc in default_suite(seed=0):
        res = evolve_plan(sc.graph, sc.machine,
                          SearchConfig(pop_size=8, generations=0), seed=0,
                          device=CPU)
        best = min(T.simulate(sc.graph, sc.machine,
                              T.make_scheduler(name)).makespan
                   for name in ("hlp_ols", "heft", "er_ls"))
        assert res.gen0_best <= best * (1 + 1e-5), sc.name
        assert res.fitness == res.gen0_best == min(res.history)


def test_final_best_never_worse_than_seeds_across_methods():
    sc = layered_scenario(n=40, layers=5, seed=3, ccr=1.0)
    for method in ("ga", "cem", "sa"):
        res = evolve_plan(sc.graph, sc.machine,
                          SearchConfig(method=method, pop_size=12,
                                       generations=4, comm_aware=True),
                          seed=2, device=CPU)
        assert res.fitness <= min(res.seed_fitness.values()) + 1e-9
        assert res.fitness == min(res.history)
        assert len(res.history) == 5


def test_bruteforce_exact_match_at_small_n():
    from repro_torch.core.bruteforce import brute_force_schedule

    for seed in (7, 11, 13):
        sc = random_scenario(n=8, seed=seed, counts=(3, 2))
        opt = brute_force_schedule(sc.graph, sc.machine).makespan
        res = evolve_plan(sc.graph, sc.machine,
                          SearchConfig(pop_size=32, generations=10), seed=0,
                          device=CPU)
        assert res.fitness == pytest.approx(opt, rel=1e-5), seed


def test_whole_search_is_one_replay_shape():
    """Three methods on one graph at one population size: one new replay
    shape (pop_size 13 + 3 seed plans: a plan count no other test uses)."""
    sc = layered_scenario(n=35, layers=5, seed=5)
    t0 = TB.trace_count("bucket")
    for method in ("ga", "cem", "sa"):
        evolve_plan(sc.graph, sc.machine,
                    SearchConfig(method=method, pop_size=13, generations=6),
                    seed=0, device=CPU)
    assert TB.trace_count("bucket") - t0 == 1


def test_evolve_plan_is_bit_reproducible():
    sc = random_scenario(n=30, seed=9)
    cfg = SearchConfig(pop_size=16, generations=6)
    a = evolve_plan(sc.graph, sc.machine, cfg, seed=42, device=CPU)
    b = evolve_plan(sc.graph, sc.machine, cfg, seed=42, device=CPU)
    assert _result(a) == _result(b)


def test_genome_plan_roundtrip_preserves_the_allocation():
    sc = layered_scenario(n=25, layers=5, seed=1)
    for name, plan in seed_plans(sc.graph, sc.machine).items():
        gn = plan_to_genome(sc.graph, sc.machine, plan)
        assert isinstance(gn, Genome)
        rebuilt = genome_to_plan(sc.graph, sc.machine, gn)
        assert np.array_equal(rebuilt.alloc, plan.alloc), name
        assert plan_to_genome(sc.graph, sc.machine, rebuilt).key() \
            == plan_to_genome(sc.graph, sc.machine, rebuilt).key()


def test_search_envelope_is_fixed_and_fits_every_genome():
    sc = random_scenario(n=22, seed=4)
    g = sc.graph
    pad_to = TB.search_envelope(g, sc.machine)
    rng = np.random.default_rng(0)
    plans = [genome_to_plan(g, sc.machine, random_genome(g, sc.machine, rng))
             for _ in range(5)]
    rows = [plan_times(g, p, g.proc)[None, :] for p in plans]
    out = TB.fixed_envelope_makespans([(g, p) for p in plans], rows, pad_to,
                                      device=CPU)
    assert len(out) == 5 and all(float(o[0]) > 0 for o in out)
    with pytest.raises(ValueError, match="exceeds the fixed envelope"):
        TB.fixed_envelope_makespans([(g, plans[0])], rows[:1],
                                    (pad_to[0] // 2, pad_to[1]), device=CPU)


def test_evo_adapters_ride_the_standard_pipeline():
    """``evo`` / ``evo_camhlp`` through the engine, ``plan_for`` and the
    pipelined sweep (threads, the plan cache) equal to the serial route."""
    sc = layered_scenario(n=20, layers=4, seed=0, ccr=0.5)
    for name in ("evo", "evo_camhlp"):
        res = T.simulate(sc.graph, sc.machine,
                         T.make_scheduler(name, device=CPU))
        assert res.schedule.makespan > 0
        assert T.plan_for(name, sc.graph, sc.machine, device=CPU) is not None
    heur = min(T.simulate(sc.graph, sc.machine,
                          T.make_scheduler(name)).makespan
               for name in ("hlp_ols", "heft", "er_ls"))
    evo_ms = T.simulate(sc.graph, sc.machine,
                        T.make_scheduler("evo", device=CPU)).makespan
    assert evo_ms <= heur * (1 + 1e-5)
    entries = [(sc.graph, sc.machine, T.make_scheduler(n, device=CPU))
               for n in ("evo", "evo_camhlp", "evo")]
    noise = T.NoiseModel("lognormal", 0.2)
    serial = TB.sweep_suite_makespans(entries, noise=noise, seeds=[0, 1],
                                      device=CPU)
    TP.clear_plan_cache()
    piped = TB.sweep_suite_makespans(entries, noise=noise, seeds=[0, 1],
                                     workers=2, cache=True, device=CPU)
    for a, b in zip(serial, piped):
        np.testing.assert_array_equal(a, b)
    assert TP.last_pipeline_stats().cache_hits >= 1   # the second "evo"


def test_search_counters_and_gauge_land_in_obs():
    sc = layered_scenario(n=20, layers=4, seed=2)
    obs.enable()
    try:
        obs.reset()
        before = dict(obs.counters())
        res = evolve_plan(sc.graph, sc.machine,
                          SearchConfig(pop_size=8, generations=3), seed=0,
                          device=CPU)
        ctrs = obs.counters()
        assert (ctrs.get("search.evals", 0)
                - before.get("search.evals", 0)) == res.evals
        assert (ctrs.get("search.cache_hits", 0)
                - before.get("search.cache_hits", 0)) == res.cache_hits
        assert obs.gauges()["search.best_fitness"] == res.fitness
        spans = [e for e in obs.wall_events()
                 if e["name"] == "search.generation"]
        assert len(spans) == 4
        recs = [r for r in obs.decision_records() if r.scheduler == "evo:ga"]
        assert len(recs) == sc.graph.n
        assert all(r.tie_break.startswith("perm:") for r in recs)
    finally:
        obs.disable()
        obs.reset()


def test_seed_plans_go_through_the_plan_cache():
    """A second search of the same graph re-solves none of its seed plans
    (``cached_solve``): three hits, no miss."""
    sc = moldable_cholesky_scenario(nb_blocks=3, seed=6)
    cfg = SearchConfig(pop_size=6, generations=1)
    TP.clear_plan_cache()
    evolve_plan(sc.graph, sc.machine, cfg, seed=0, device=CPU)
    h0 = obs.counter_value("plan_cache.hits")
    m0 = obs.counter_value("plan_cache.misses")
    evolve_plan(sc.graph, sc.machine, cfg, seed=1, device=CPU)
    assert obs.counter_value("plan_cache.hits") - h0 == 3
    assert obs.counter_value("plan_cache.misses") == m0


def test_search_config_rejects_unknown_method_and_tiny_pop():
    with pytest.raises(ValueError, match="unknown search method"):
        SearchConfig(method="hillclimb")
    with pytest.raises(ValueError, match="pop_size"):
        SearchConfig(pop_size=1)
