"""The port's campaign entry: the simulation sweep, the plan search and the
allocation solvers.

The counterpart of the JAX package's ``benchmarks/campaign.py``
(``sim_sweep``, ``search_sweep``) and of the ``sim`` / ``search`` /
``solver`` targets of ``benchmarks/run.py``, run on ``repro_torch``: every
static plan of the sweep is replayed by the replay kernel on the card
through the pipelined executor (``repro_torch.sim.pipeline``), the network
sub-grid's ``maxmin_fair`` cells are priced by the contention kernel, every
generation of the search is scored by one replay launch, and every
first-order LP (the ``hlp_jax_ols`` adapter of the full grid, the
``solver`` target) is one launch of the ``hlp_fo`` kernel.  It writes the
same ``repro.bench.v1`` trajectory as ``benchmarks/run.py``, so the JAX
package's gate holds the port to the pinned values::

  PYTHONPATH=src python -m repro_torch.launch.campaign --bench-json X
  PYTHONPATH=src python -m repro_torch.launch.campaign --device cpu --bench-json X
  python -m benchmarks.render_tables --check-bench X benchmarks/BENCH_pinned.json

``--full`` runs the reference's full grids (``benchmarks/run.py --full``):
32 noise seeds, the (16, 4) suites and ``hlp_jax_ols`` among the static
adapters of ``sim``, the larger search, and potri nb=20 in ``solver``.
``sim`` runs before ``search`` in one process, as ``benchmarks/run.py``
runs them: the ``compiles`` counts (new replay shapes, the reference's XLA
traces) are per process.  Per-instance CSVs land in ``artifacts/torch/``.
The module imports torch only inside its functions: the planning pool's
workers re-run it as their ``__main__`` and need none.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import platform as _platform
import sys
from collections import defaultdict
from dataclasses import replace as dataclasses_replace
from pathlib import Path

from typing import TYPE_CHECKING

import numpy as np

from repro_torch import obs
from repro_torch.obs import registry as _obs

if TYPE_CHECKING:
    import torch

ART = Path(__file__).resolve().parents[3] / "artifacts" / "torch"


def _write_csv(name: str, header: list[str], rows: list[list]) -> str:
    ART.mkdir(parents=True, exist_ok=True)
    path = ART / name
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return str(path)


def sim_sweep(full: bool = False, noise_scale: float = 0.2,
              num_seeds: int | None = None, ccr: float = 0.5,
              verbose: bool = False, base_seed: int = 0,
              device: str | torch.device = "cuda") -> dict:
    """Every scheduler adapter × every scenario family × noise seeds — the
    JAX package's ``benchmarks/campaign.py::sim_sweep`` on the port.

    The suite mixes the communication-free families with their CCR-enabled
    variants and the network-bound ``netbound`` instance.  The static
    adapters (hlp_est / hlp_ols / cahlp_ols / heft / heft_nocomm) allocate
    once per scenario, then the whole (scenario × scheduler × seed) grid —
    including the noise-free row — replays through the pipelined executor
    on ``device``: one replay launch per shape bucket.  Arrival-driven
    adapters (er_ls / eft / greedy / random) run the scalar engine per
    seed.  Reports the mean makespan over the lower bound
    (``ratio_denominator``), the noise degradation, the comm-aware gains of
    HEFT and of the CAHLP allocation, the two moldable sub-campaigns
    (``mhlp_width_gain``, ``camhlp_comm_gain``) and the network-model
    sub-grid's ``contention_gap`` (its ``maxmin_fair`` cells priced by the
    contention kernel).

    All three sub-grids run through the pipelined executor
    (``repro_torch.sim.pipeline``): plan construction fans out over the
    ``REPRO_PLAN_WORKERS`` pool, the content-addressed plan cache collapses
    repeated allocations (the netbound grid re-uses each allocation across
    its three network models), and each shape bucket is dispatched as soon
    as it closes.  ``base_seed`` shifts every scenario-generator seed.

    ``full=True`` is the reference's full grid: 32 noise seeds, the
    (16, 4) default and comm suites beside the (8, 2) ones, the first-order
    ``hlp_jax_ols`` among the static adapters (its LP solved on ``device``),
    8 instances a moldable sub-campaign and 6 netbound instances.
    """
    from repro_torch.core.theory import ratio_denominator
    from repro_torch.device import resolve_device
    from repro_torch.sim import NoiseModel, make_scheduler, simulate
    from repro_torch.sim.adapters import CommAwareHLPScheduler
    from repro_torch.sim.batch import sample_actual_batch, trace_count
    from repro_torch.sim.network import make_network
    from repro_torch.sim.pipeline import (clear_plan_cache,
                                          last_pipeline_stats,
                                          pipelined_sweep_makespans)
    from repro_torch.sim.scenarios import (comm_suite, default_suite,
                                           moldable_suite, netbound_scenario)

    dev = resolve_device(device)
    num_seeds = num_seeds or (32 if full else 8)
    noise = NoiseModel("lognormal", noise_scale)
    seeds = list(range(num_seeds))
    suite = default_suite(seed=base_seed) + comm_suite(seed=base_seed + 50,
                                                       ccr=ccr)
    if full:
        suite += default_suite(seed=base_seed + 100, counts=(16, 4))
        suite += comm_suite(seed=base_seed + 150, counts=(16, 4), ccr=ccr)
    static = (["hlp_est", "hlp_ols", "cahlp_ols", "heft", "heft_nocomm"]
              + (["hlp_jax_ols"] if full else []))
    online = ["er_ls", "eft", "greedy_r2", "random"]

    def make_static(name: str):
        if name == "hlp_jax_ols":
            return make_scheduler(name, device=str(dev))
        return make_scheduler(name)

    # the cache is cleared up front so the reported hit rate measures this
    # grid's redundancy, not earlier calls'
    clear_plan_cache()
    traces0 = trace_count("bucket")
    tr_contended0 = trace_count("contended")
    phase_seconds: dict[str, float] = {}
    pipe_stats = []

    def sample_grid(g, plan):
        clean_row = sample_actual_batch(g, plan, NoiseModel(), [0])
        noisy = sample_actual_batch(g, plan, noise, seeds)
        return np.vstack([clean_row, noisy])

    entries, keys = [], []
    lbs = {}
    for sc in suite:
        lbs[sc.name] = ratio_denominator(sc.graph, sc.counts)
        for name in static:
            entries.append((sc.graph, sc.machine, make_static(name)))
            keys.append((sc.name, name))
    with _obs.timer("campaign.sim.static", algs=len(entries)) as sp:
        sweeps = pipelined_sweep_makespans(entries, sample_fn=sample_grid,
                                           device=dev)
    phase_seconds["static"] = sp.dur
    pipe_stats.append(last_pipeline_stats())

    # moldable sub-campaigns: width-aware MHLP vs its width-1 restriction,
    # and comm-aware CAMHLP vs oblivious MHLP at CCR 2
    m_num = 8 if full else 4
    m_suite = [(sc, ("mhlp_ols", "hlp_ols"))
               for sc in moldable_suite(seed=base_seed + 200, num=m_num)]
    m_suite += [(sc, ("camhlp_ols", "mhlp_ols"))
                for sc in moldable_suite(seed=base_seed + 400, num=m_num,
                                         ccr=2.0)]
    m_entries, m_keys = [], []
    for sc, algs in m_suite:
        lbs[sc.name] = ratio_denominator(sc.graph, sc.counts)
        for name in algs:
            m_entries.append((sc.graph, sc.machine, make_scheduler(name)))
            m_keys.append((sc.name, name))
    with _obs.timer("campaign.sim.moldable", algs=len(m_entries)) as sp:
        m_sweeps = pipelined_sweep_makespans(m_entries, sample_fn=sample_grid,
                                             device=dev)
    phase_seconds["moldable"] = sp.dur
    pipe_stats.append(last_pipeline_stats())

    # network-model sub-grid (netbound): the oblivious hlp_ols allocation
    # and the contention-aware CAHLP, each replayed under instant /
    # fixed_latency / maxmin_fair; one flat entry per (scenario, allocation,
    # network), the plan cache collapsing each allocation to one solve
    nets = {name: make_network(name)
            for name in ("instant", "fixed_latency", "maxmin_fair")}
    n_suite = [netbound_scenario(seed=base_seed + 300 + i)
               for i in range(6 if full else 3)]
    n_allocs = [("hlp_ols", lambda: make_scheduler("hlp_ols")),
                ("cahlp_ctn", lambda: CommAwareHLPScheduler(contention=True))]
    n_entries, n_keys, n_nets = [], [], []
    for sc in n_suite:
        lbs[sc.name] = ratio_denominator(sc.graph, sc.counts)
        for name, mk in n_allocs:
            for net_name, net in nets.items():
                n_entries.append((sc.graph, sc.machine, mk()))
                n_keys.append((sc.name, name, net_name))
                n_nets.append(net)
    with _obs.timer("campaign.sim.network", algs=len(n_entries)) as sp:
        n_sweeps = pipelined_sweep_makespans(n_entries, sample_fn=sample_grid,
                                             networks=n_nets, device=dev)
    phase_seconds["network"] = sp.dur
    pipe_stats.append(last_pipeline_stats())
    compiles = trace_count("bucket") - traces0
    tr_contended1 = trace_count("contended")

    rows, agg = [], defaultdict(list)
    results = {k: (float(v[0]), v[1:]) for k, v in zip(keys, sweeps)}
    n_runs = 0
    for sc in suite:
        lb = lbs[sc.name]
        for name in static + online:
            if name in static:
                clean, ms = results[(sc.name, name)]
            else:
                # the random policy must draw a fresh stream per run
                kw = {"seed": 0} if name == "random" else {}
                clean = simulate(sc.graph, sc.machine,
                                 make_scheduler(name, **kw),
                                 seed=0).makespan
                ms = np.array([simulate(
                    sc.graph, sc.machine,
                    make_scheduler(name, **({"seed": s} if name == "random"
                                            else {})),
                    noise=noise, seed=s).makespan for s in seeds])
            n_runs += len(seeds)
            mean = float(ms.mean())
            agg[name].append(mean / lb)
            agg[f"degrade_{name}"].append(mean / clean)
            if sc.graph.has_comm:
                agg[f"comm_{name}"].append(mean / lb)
            rows.append([sc.name, sc.family, name, lb, clean, mean,
                         float(ms.std()), float(np.percentile(ms, 95)),
                         len(seeds)])
        # the communication claims, only where the graph carries comm
        if sc.graph.has_comm:
            agg["heft_comm_gain"].append(
                results[(sc.name, "heft_nocomm")][1].mean()
                / results[(sc.name, "heft")][1].mean())
            agg["cahlp_comm_gain"].append(
                results[(sc.name, "hlp_ols")][1].mean()
                / results[(sc.name, "cahlp_ols")][1].mean())
            if sc.family == "netbound":
                agg["cahlp_netbound_gain"].append(agg["cahlp_comm_gain"][-1])
        if verbose:
            print(f"  sim_sweep {sc.name} done")

    m_results = {k: (float(v[0]), v[1:]) for k, v in zip(m_keys, m_sweeps)}
    for sc, algs in m_suite:
        lb = lbs[sc.name]
        for name in algs:
            clean, ms = m_results[(sc.name, name)]
            n_runs += len(seeds)
            mean = float(ms.mean())
            agg[f"moldable_{name}"].append(mean / lb)
            rows.append([sc.name, sc.family, name, lb, clean, mean,
                         float(ms.std()), float(np.percentile(ms, 95)),
                         len(seeds)])
        if algs == ("mhlp_ols", "hlp_ols"):
            agg["mhlp_width_gain"].append(
                m_results[(sc.name, "hlp_ols")][1].mean()
                / m_results[(sc.name, "mhlp_ols")][1].mean())
        else:
            agg["camhlp_comm_gain"].append(
                m_results[(sc.name, "mhlp_ols")][1].mean()
                / m_results[(sc.name, "camhlp_ols")][1].mean())
        if verbose:
            print(f"  sim_sweep {sc.name} done")

    n_results = {k: (float(v[0]), v[1:]) for k, v in zip(n_keys, n_sweeps)}
    for sc in n_suite:
        lb = lbs[sc.name]
        for name, _ in n_allocs:
            for net_name in nets:
                clean, ms = n_results[(sc.name, name, net_name)]
                n_runs += len(seeds)
                mean = float(ms.mean())
                agg[f"net_{net_name}_{name}"].append(mean / lb)
                rows.append([sc.name, sc.family, f"{name}@{net_name}", lb,
                             clean, mean, float(ms.std()),
                             float(np.percentile(ms, 95)), len(seeds)])
        agg["contention_gap"].append(
            n_results[(sc.name, "hlp_ols", "maxmin_fair")][1].mean()
            / n_results[(sc.name, "cahlp_ctn", "maxmin_fair")][1].mean())
        if verbose:
            print(f"  sim_sweep {sc.name} (network grid) done")
    _write_csv("sim_sweep.csv",
               ["scenario", "family", "scheduler", "lower_bound",
                "makespan_clean", "makespan_noisy_mean", "makespan_noisy_std",
                "makespan_noisy_p95", "seeds"], rows)
    plans = len(entries) + len(m_entries) + len(n_entries)
    pipe_total = sum(st.total_s for st in pipe_stats)
    cache_hits = sum(st.cache_hits for st in pipe_stats)
    cache_misses = sum(st.cache_misses for st in pipe_stats)
    return {"ratios": {k: float(np.mean(v)) for k, v in agg.items()},
            "schedulers": static + online, "runs": n_runs,
            "scenarios": len(suite) + len(m_suite) + len(n_suite),
            "compiles": compiles,
            "plans": plans,
            "phase_seconds": phase_seconds,
            # every bucketed plan evaluates 1 clean + num_seeds noisy rows
            "evals": plans * (num_seeds + 1),
            "contended_compiles": tr_contended1 - tr_contended0,
            "buckets": sum(st.buckets for st in pipe_stats),
            "plan_build_s": sum(st.plan_build_s for st in pipe_stats),
            "build_wall_s": sum(st.build_wall_s for st in pipe_stats),
            "solve_max_s": max(st.solve_max_s for st in pipe_stats),
            "drain_s": sum(st.drain_s for st in pipe_stats),
            "overlap_frac": (sum(st.overlap_s for st in pipe_stats)
                             / pipe_total if pipe_total else 0.0),
            "plan_cache_hits": cache_hits,
            "plan_cache_misses": cache_misses,
            "plan_cache_hit_rate": (cache_hits / (cache_hits + cache_misses)
                                    if cache_hits + cache_misses else 0.0),
            "plan_workers": max(st.workers for st in pipe_stats)}


def search_sweep(full: bool = False, verbose: bool = False,
                 base_seed: int = 0,
                 device: str | torch.device = "cuda") -> dict:
    """Population-based plan search vs the paper's pipeline — the JAX
    package's ``benchmarks/campaign.py::search_sweep`` on the port.

    For each (scenario × search seed) cell, ``repro_torch.search.evolve_plan``
    evolves (allocation, priority) genomes — generation 0 seeded with the
    canonical-rounded LP plan, HEFT and ER-LS — scoring every generation as
    one fixed-shape batch (one replay launch on ``device``; one replay
    shape per scenario envelope for the whole search).  The headline is
    ``evo_gap``: best-heuristic-seed makespan over the evolved optimum.  The
    evolved plan beats or matches the best seed on every cell by
    construction; the sweep raises if that breaks.  ``cem_vs_ga`` /
    ``sa_vs_ga`` compare the other methods on the first scenario.
    ``base_seed`` shifts the scenario and search seeds.
    """
    from repro_torch.core.theory import ratio_denominator
    from repro_torch.device import resolve_device
    from repro_torch.search import SearchConfig, evolve_plan
    from repro_torch.sim.batch import search_envelope, trace_count
    from repro_torch.sim.scenarios import (fork_join_scenario,
                                           layered_scenario, random_scenario)

    dev = resolve_device(device)
    # CCR = 1 on the layered family: communication-bound layers are where
    # ordering/mapping search has headroom over LP+OLS
    suite = [layered_scenario(n=60, layers=6, seed=base_seed + 11, ccr=1.0),
             random_scenario(n=50, seed=base_seed + 23),
             fork_join_scenario(width=24, phases=5, seed=base_seed + 37)]
    if full:
        suite += [layered_scenario(n=240, layers=12, seed=base_seed + 41,
                                   ccr=1.0),
                  random_scenario(n=500, p_edge=0.02, seed=base_seed + 53)]
    seeds = list(range(3 if full else 2))
    cfg = SearchConfig(method="ga", pop_size=48 if full else 32,
                       generations=20 if full else 12)
    cfg_comm = dataclasses_replace(cfg, comm_aware=True)

    traces0 = trace_count("bucket")
    rows, agg = [], defaultdict(list)
    evals = cache_hits = 0
    phase_seconds: dict[str, float] = {}
    with _obs.timer("campaign.search.evolve",
                    cells=len(suite) * len(seeds)) as sp:
        for sc in suite:
            lb = ratio_denominator(sc.graph, sc.counts)
            c = cfg_comm if sc.graph.has_comm else cfg
            for s in seeds:
                res = evolve_plan(sc.graph, sc.machine, c,
                                  seed=base_seed + s, device=dev)
                best_seed = min(res.seed_fitness.values())
                if res.fitness > best_seed + 1e-9:
                    raise RuntimeError(
                        f"anytime dominance broken on {sc.name} seed {s}: "
                        f"evolved {res.fitness} > best seed {best_seed}")
                evals += res.evals
                cache_hits += res.cache_hits
                agg["evo_gap"].append(best_seed / res.fitness)
                agg["evo_vs_lb"].append(res.fitness / lb)
                agg["lp_vs_evo"].append(res.seed_fitness["lp"] / res.fitness)
                agg["anytime_gain"].append(res.gen0_best / res.fitness)
                rows.append([sc.name, sc.family, sc.graph.n, s, res.method,
                             lb, res.seed_fitness["lp"],
                             res.seed_fitness["heft"],
                             res.seed_fitness["er_ls"], res.gen0_best,
                             res.fitness, best_seed / res.fitness,
                             res.evals, res.cache_hits,
                             len(res.history) - 1])
                if verbose:
                    print(f"  search_sweep {sc.name} seed={s} "
                          f"gap={best_seed / res.fitness:.4f}")
    phase_seconds["evolve"] = sp.dur

    # method shoot-out on the first scenario
    sc0 = suite[0]
    c0 = cfg_comm if sc0.graph.has_comm else cfg
    ga_best = rows[0][10]
    with _obs.timer("campaign.search.methods") as sp:
        for meth in ("cem", "sa"):
            r = evolve_plan(sc0.graph, sc0.machine,
                            dataclasses_replace(c0, method=meth),
                            seed=base_seed, device=dev)
            agg[f"{meth}_vs_ga"].append(r.fitness / ga_best)
            rows.append([sc0.name, sc0.family, sc0.graph.n, 0, meth,
                         ratio_denominator(sc0.graph, sc0.counts),
                         r.seed_fitness["lp"], r.seed_fitness["heft"],
                         r.seed_fitness["er_ls"], r.gen0_best, r.fitness,
                         min(r.seed_fitness.values()) / r.fitness,
                         r.evals, r.cache_hits, len(r.history) - 1])
            evals += r.evals
            cache_hits += r.cache_hits
    phase_seconds["methods"] = sp.dur

    compiles = trace_count("bucket") - traces0
    buckets = len({search_envelope(sc.graph, sc.machine) for sc in suite})
    if compiles > buckets:
        raise RuntimeError(f"search_sweep replayed {compiles} shapes for "
                           f"{buckets} shape buckets")
    _write_csv("search_sweep.csv",
               ["scenario", "family", "n", "seed", "method", "lower_bound",
                "lp_seed", "heft_seed", "er_ls_seed", "gen0_best", "best",
                "evo_gap", "evals", "cache_hits", "generations"], rows)
    return {"ratios": {k: float(np.mean(v)) for k, v in agg.items()},
            "cells": len(suite) * len(seeds), "scenarios": len(suite),
            "max_n": max(sc.graph.n for sc in suite),
            "compiles": compiles, "buckets": buckets,
            "evals": evals, "cache_hits": cache_hits,
            "phase_seconds": phase_seconds}


# ----------------------------------------------------------- bench targets
def _launches() -> dict[str, int]:
    """The replay, contention and first-order LP kernels' launch counters
    (the LP's total and its sm90 kernel's), beside the replay chunks
    dispatched and the contention groups priced (on the card, one launch
    each; on the CPU, none)."""
    from repro_torch.kernels.contention import contention as C
    from repro_torch.kernels.hlp_fo import hlp_fo as HF
    from repro_torch.kernels.replay import replay as R
    return {"replay": R.launch_count(), "contention": C.launch_count(),
            "hlp_fo": HF.launch_count(),
            "hlp_fo_sm90": HF.launch_counts()["sm90"],
            "replay_chunks": _obs.counter_value("sim.replay.chunks"),
            "contended_groups": _obs.counter_value("sim.contended.groups")}


def bench_sim(full: bool, seed: int, device) -> tuple[list[str], dict]:
    """The ``sim`` target of ``benchmarks/run.py``: CSV lines and the
    ``benches.sim`` extras of the trajectory."""
    with obs.timer("bench.sim") as sp:
        r = sim_sweep(full=full, base_seed=seed, device=device)
    dt = sp.dur
    per = dt / max(r["runs"], 1) * 1e6
    lines = []
    for alg in r["schedulers"]:
        lines.append(f"sim/{alg},{per:.0f},"
                     f"mean_ratio_lb={r['ratios'][alg]:.4f};"
                     f"noise_degrade={r['ratios']['degrade_' + alg]:.4f}")
    gain = (r["ratios"]["heft_comm_gain"] - 1) * 100
    lines.append(f"sim/heft_comm_gain,{per:.0f},oblivious_penalty_pct={gain:.2f}")
    again = (r["ratios"]["cahlp_comm_gain"] - 1) * 100
    nbgain = (r["ratios"]["cahlp_netbound_gain"] - 1) * 100
    lines.append(f"sim/cahlp_comm_gain,{per:.0f},oblivious_penalty_pct={again:.2f};"
                 f"netbound_pct={nbgain:.2f}")
    wgain = (r["ratios"]["mhlp_width_gain"] - 1) * 100
    lines.append(f"sim/mhlp_width_gain,{per:.0f},width1_penalty_pct={wgain:.2f}")
    cmgain = (r["ratios"]["camhlp_comm_gain"] - 1) * 100
    lines.append(f"sim/camhlp_comm_gain,{per:.0f},oblivious_penalty_pct={cmgain:.2f}")
    ctgain = (r["ratios"]["contention_gap"] - 1) * 100
    spread = (r["ratios"]["net_maxmin_fair_hlp_ols"]
              / r["ratios"]["net_instant_hlp_ols"] - 1) * 100
    lines.append(f"sim/contention_gap,{per:.0f},oblivious_penalty_pct={ctgain:.2f};"
                 f"netmodel_spread_pct={spread:.2f}")
    from repro_torch.sim.batch import campaign_devices
    bucket_s = sum(r["phase_seconds"].values())
    throughput = r["evals"] / max(bucket_s, 1e-9)
    per_device = throughput / max(len(campaign_devices(device)), 1)
    lines.append(f"sim/throughput_plans_per_sec,{per:.0f},"
                 f"plans_per_sec={throughput:.1f};"
                 f"per_device={per_device:.1f}")
    lines.append(f"sim/plan_build_s,{per:.0f},"
                 f"plan_build_s={r['plan_build_s']:.3f};"
                 f"overlap_frac={r['overlap_frac']:.3f};"
                 f"workers={r['plan_workers']}")
    lines.append(f"sim/plan_cache,{per:.0f},"
                 f"hits={r['plan_cache_hits']};"
                 f"misses={r['plan_cache_misses']};"
                 f"hit_rate={r['plan_cache_hit_rate']:.3f}")
    extras = {key: r[key] for key in (
        "phase_seconds", "compiles", "contended_compiles", "plans", "evals",
        "runs", "scenarios", "buckets", "plan_build_s", "build_wall_s",
        "solve_max_s", "drain_s",
        "overlap_frac", "plan_cache_hits", "plan_cache_misses",
        "plan_cache_hit_rate", "plan_workers")}
    extras.update(throughput_plans_per_sec=throughput,
                  throughput_plans_per_sec_per_device=per_device,
                  metrics=r["ratios"])
    print(f"# sim: {r['runs']} runs over {r['scenarios']} scenarios in "
          f"{dt:.1f}s | {r['plans']} static plans in {r['compiles']} replay "
          f"shapes (bucketed, +{r['contended_compiles']} contended) | "
          f"{throughput:.0f} plan-evals/s over the bucketed phases")
    print(f"#   pipelined executor: {r['plan_build_s']:.2f}s of solver time "
          f"over {r['plan_workers']} worker(s) in {r['build_wall_s']:.2f}s "
          f"of build wall (longest solve {r['solve_max_s']:.3f}s), "
          f"overlap_frac={r['overlap_frac']:.3f}, drain "
          f"{r['drain_s']:.4f}s, plan cache {r['plan_cache_hits']}/"
          f"{r['plan_cache_hits'] + r['plan_cache_misses']} hits")
    return lines, extras


def bench_search(full: bool, seed: int, device) -> tuple[list[str], dict]:
    """The ``search`` target of ``benchmarks/run.py``."""
    with obs.timer("bench.search") as sp:
        r = search_sweep(full=full, base_seed=seed, device=device)
    dt = sp.dur
    per = dt / max(r["cells"], 1) * 1e6
    gap = (r["ratios"]["evo_gap"] - 1) * 100
    lines = [f"sim/evo_gap,{per:.0f},seed_excess_pct={gap:.2f};"
             f"mean_ratio={r['ratios']['evo_gap']:.4f}",
             f"search/evo_vs_lb,{per:.0f},"
             f"mean_ratio_lb={r['ratios']['evo_vs_lb']:.4f}",
             f"search/lp_vs_evo,{per:.0f},"
             f"lp_excess_pct={(r['ratios']['lp_vs_evo'] - 1) * 100:.2f}",
             f"search/anytime_gain,{per:.0f},"
             f"beyond_gen0_pct={(r['ratios']['anytime_gain'] - 1) * 100:.2f}"]
    for meth in ("cem", "sa"):
        lines.append(f"search/{meth}_vs_ga,{per:.0f},"
                     f"ratio={r['ratios'][f'{meth}_vs_ga']:.4f}")
    search_s = sum(r["phase_seconds"].values())
    throughput = r["evals"] / max(search_s, 1e-9)
    lines.append(f"search/throughput_evals_per_sec,{per:.0f},"
                 f"evals_per_sec={throughput:.1f}")
    extras = {key: r[key] for key in (
        "phase_seconds", "compiles", "buckets", "cells", "max_n", "evals",
        "cache_hits")}
    extras.update(throughput_evals_per_sec=throughput, metrics=r["ratios"])
    print(f"# search: {r['cells']} (scenario × seed) cells up to "
          f"n={r['max_n']} in {dt:.1f}s | {r['evals']} genome evals "
          f"(+{r['cache_hits']} cache hits) in {r['compiles']} replay shapes "
          f"over {r['buckets']} shape buckets | {throughput:.0f} evals/s")
    return lines, extras


def bench_solver(full: bool, seed: int, device) -> tuple[list[str], dict]:
    """The ``solver`` target of ``benchmarks/run.py``: the allocation
    phase's runtime, the exact HiGHS LP against the first-order solve
    (``solve_hlp_jax``, 300 iterations, on ``device``) on Chameleon potrf
    and getrf nb=10 at block 512 on (64, 8), and potri nb=20 with
    ``full``.  The first first-order solve includes the kernel's build."""
    from repro_torch.core.hlp import solve_hlp
    from repro_torch.core.hlp_jax import solve_hlp_jax
    from repro_torch.core.workloads import chameleon

    lines, instances = [], {}
    insts = [("potrf", 10), ("getrf", 10)] + ([("potri", 20)] if full else [])
    for app, nb in insts:
        g = chameleon(app, nb, 512)
        with obs.timer(f"bench.solver.exact.{app}{nb}") as sp_e:
            exact = solve_hlp(g, 64, 8)
        with obs.timer(f"bench.solver.first_order.{app}{nb}") as sp_f:
            approx = solve_hlp_jax(g, 64, 8, iters=300, device=device)
        gap = (approx.lp_value / exact.lp_value - 1) * 100
        lines.append(f"solver/{app}{nb}_exact,{sp_e.dur * 1e6:.0f},"
                     f"lp={exact.lp_value:.4f}")
        lines.append(f"solver/{app}{nb}_jax,{sp_f.dur * 1e6:.0f},"
                     f"gap_pct={gap:.3f}")
        instances[f"{app}{nb}"] = {"n": g.n, "exact_s": sp_e.dur,
                                   "first_order_s": sp_f.dur,
                                   "lp": exact.lp_value,
                                   "first_order_lp": approx.lp_value,
                                   "gap_pct": gap}
        print(f"# solver {app}{nb} (n={g.n}): HiGHS {sp_e.dur:.3f}s, "
              f"first-order {sp_f.dur:.3f}s on {device}, gap {gap:.3f}%")
    return lines, {"instances": instances}


BENCHES = {"sim": bench_sim, "search": bench_search, "solver": bench_solver}
DEFAULT_TARGETS = ("sim", "search")   # what a run without --only runs


def _host_info(device) -> dict:
    """The substrate a trajectory was measured on."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.sim import campaign_devices, contention_kernel

    dev = resolve_device(device)
    devs = campaign_devices(dev)
    return {"backend": dev.type,
            "device_count": len(devs),
            "devices": [torch.cuda.get_device_name(d) if d.type == "cuda"
                        else "cpu" for d in devs],
            "contention_kernel": contention_kernel(),
            "torch": torch.__version__,
            "python": _platform.python_version()}


def write_bench_json(path: str, args, names: list[str],
                     benches: dict[str, dict],
                     obs_section: dict | None = None) -> None:
    """Write the ``repro.bench.v1`` trajectory, as ``benchmarks/run.py``'s
    ``write_bench_json`` writes it: ``schema``, ``run`` {seed, full,
    targets}, ``host`` and ``benches.<name>`` {wall_s, lines, ...extras}.
    A partial-target run keeps the other benches of a same-(seed, full)
    file at ``path``; a different seed/full (or a corrupt file) is
    overwritten.  ``args.full`` defaults to False."""
    full = bool(getattr(args, "full", False))
    carried: dict[str, dict] = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                old = json.load(f)
        except (OSError, ValueError):
            old = None
        if (isinstance(old, dict) and old.get("schema") == "repro.bench.v1"
                and old.get("run", {}).get("seed") == args.seed
                and old.get("run", {}).get("full") == full):
            carried = {k: v for k, v in old.get("benches", {}).items()
                       if k not in benches}
    if carried:
        benches = {**carried, **benches}
        names = sorted(set(names) | set(carried))
    doc = {"schema": "repro.bench.v1",
           "run": {"seed": args.seed, "full": full, "targets": names},
           "host": _host_info(args.device),
           "benches": benches}
    if obs_section is not None:
        doc["obs"] = obs_section
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"# wrote {path}"
          + (f" (kept earlier benches: {','.join(sorted(carried))})"
             if carried else ""))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", type=str, default="",
                    help="comma-separated subset of: " + ",".join(BENCHES)
                         + " (default: " + ",".join(DEFAULT_TARGETS) + ")")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed: shifts every scenario generator seed")
    ap.add_argument("--full", action="store_true",
                    help="the reference's full grids (benchmarks/run.py "
                         "--full): hlp_jax_ols and the (16, 4) suites in "
                         "sim, the larger search, potri nb=20 in solver")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the replay, contention and first-order LP "
                         "run: cuda (the kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--bench-json", type=str,
                    default=str(ART / "BENCH_sim.json"),
                    help="where to write the repro.bench.v1 trajectory "
                         "(empty string disables)")
    ap.add_argument("--trace", type=str, default="",
                    help="directory for Perfetto-loadable chrome traces: "
                         "enables repro_torch.obs and writes "
                         "trace_<bench>.json plus decisions_<bench>.json "
                         "per target")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device

    names = [n for n in args.only.split(",") if n] or list(DEFAULT_TARGETS)
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        print(f"unknown --only target(s): {','.join(unknown)}; "
              f"have {','.join(BENCHES)}", file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    print(f"# repro_torch.launch.campaign: targets={','.join(names)} "
          f"full={args.full} device={dev} base_seed={args.seed}", flush=True)
    if args.trace:
        obs.enable()
        os.makedirs(args.trace, exist_ok=True)
    all_lines = ["name,us_per_call,derived"]
    benches: dict[str, dict] = {}
    trace_files: dict[str, str] = {}
    for name in names:
        print(f"== {name} ==", flush=True)
        if args.trace:
            obs.reset()
        before = _launches()
        with obs.timer(f"run.{name}") as sp:
            lines, extras = BENCHES[name](args.full, args.seed, dev)
        after = _launches()
        all_lines += lines
        benches[name] = {"wall_s": sp.dur, "lines": lines, **extras,
                         "launches": {k: after[k] - before[k]
                                      for k in after}}
        print(f"# {name}: wall {sp.dur:.3f}s, kernel launches "
              f"{benches[name]['launches']}", flush=True)
        if args.trace:
            tpath = os.path.join(args.trace, f"trace_{name}.json")
            obs.export_chrome_trace(tpath, obs.wall_trace_events())
            trace_files[name] = tpath
            recs = obs.decision_records()
            if recs:
                obs.dump_decisions(
                    os.path.join(args.trace, f"decisions_{name}.json"), recs)
    print("\n".join(all_lines))
    obs_section = None
    if args.trace:
        obs_section = {"counters": obs.counters(), "gauges": obs.gauges(),
                       "traces": trace_files}
    if args.bench_json:
        write_bench_json(args.bench_json, args, names, benches, obs_section)
    return 0


if __name__ == "__main__":
    sys.exit(main())
