"""Population-based plan search on the bucketed evaluator — the port of the
JAX package's ``repro.search.evolve``.

``evolve_plan`` treats (allocation vector, priority permutation) as a
genome (:mod:`repro_torch.search.genome`) and evolves a population whose
*whole generation* scores as one batch through the padded/bucketed replay
(``repro_torch.sim.batch.fixed_envelope_makespans``: one launch of the
replay kernel a generation on the card): every call pads to the fixed
:func:`repro_torch.sim.batch.search_envelope` and a constant plan count, so
an entire run — every generation of every method — replays **one** shape
(``trace_count("bucket")`` asserts it).

Three methods share the same batched-score kernel behind one
:class:`SearchConfig`:

  * ``ga``  — ESTEE-style genetic algorithm: tournament selection, order
    crossover on the permutation + two-point crossover on the mapping,
    precedence-safe mutation, elitism.
  * ``cem`` — cross-entropy method: per-task categorical type/width
    distributions and Gaussian permutation scores, refit on the elite
    fraction each generation with smoothing.
  * ``sa``  — vectorized simulated annealing: ``pop_size`` parallel
    chains, per-chain Metropolis acceptance on a geometric temperature
    schedule.

Generation 0 always scores the canonical-rounded LP plan, HEFT, and ER-LS
(:func:`repro_torch.search.genome.seed_plans`) alongside the population, and the
incumbent best is tracked over *everything ever scored* — so the search is
anytime-no-worse than the best existing heuristic, by construction.

Identical genomes are deduplicated by content hash before scoring and
fitness is cached across generations (``search.evals`` counts actual
evaluations, ``search.cache_hits`` the hits).  Each generation runs under a
``search.generation`` span, the running optimum lands in the
``search.best_fitness`` gauge, and — when the obs registry is enabled —
the winning genome leaves one :class:`repro_torch.obs.DecisionRecord` per
task.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dag import TaskGraph
from repro_torch.obs import registry as _obs
from repro_torch.sim.engine import Machine, Plan, plan_times

from .genome import (Genome, alloc_crossover, genome_to_plan, mutate_alloc,
                     mutate_perm, order_crossover, plan_to_genome,
                     random_genome, seed_plans, topo_perm, width_caps)

METHODS = ("ga", "cem", "sa")


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """One knob set for every search method (unused fields are ignored)."""

    method: str = "ga"            # "ga" | "cem" | "sa"
    pop_size: int = 32            # genomes scored per generation
    generations: int = 10         # generations after generation 0
    elite_frac: float = 0.25      # survivors (ga) / refit fraction (cem)
    cx_prob: float = 0.9          # ga: crossover probability
    mut_prob: float = 0.4         # ga: per-child mutation probability
    indpb: float = 0.1            # per-gene mapping mutation rate
    perm_moves: int = 2           # insertion moves per permutation mutation
    tournament: int = 3           # ga: tournament size
    cem_alpha: float = 0.7        # cem: distribution smoothing
    sa_temp: float = 0.1          # sa: initial temperature, × gen-0 best
    sa_decay: float = 0.85        # sa: geometric cooling factor
    comm_aware: bool = False      # comm tie-break + comm/moldable LP seeds
    seed_adapters: tuple[str, ...] | None = None  # override the seed set

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown search method {self.method!r}; "
                             f"have {METHODS}")
        if self.pop_size < 2:
            raise ValueError("pop_size must be >= 2")


@dataclasses.dataclass
class SearchResult:
    """What ``evolve_plan`` hands back."""

    plan: Plan                    # best plan ever scored (genome or seed)
    fitness: float                # its clean (noise-free) makespan
    genome: Genome                # genome encoding of the winner
    history: list[float]          # best-so-far per generation (incl. gen 0)
    gen0_best: float              # best fitness after generation 0
    seed_fitness: dict[str, float]  # per-heuristic-seed clean makespan
    evals: int                    # genomes actually scored (cache misses)
    cache_hits: int               # scores served from the fitness cache
    method: str


class _BatchScorer:
    """Dedup + cache + fixed-shape batched scoring shared by all methods.

    Every call scores exactly ``batch`` plans (padding with repeats of the
    first) through ``fixed_envelope_makespans`` at the fixed
    ``search_envelope`` on ``device`` — constant shapes on both axes, so
    the whole search replays one shape.
    """

    def __init__(self, g: TaskGraph, machine: Machine, batch: int, *,
                 comm_tiebreak: bool, devices=None,
                 device: str | torch.device = "cuda"):
        from repro_torch.sim.batch import search_envelope

        self.g, self.machine, self.batch = g, machine, batch
        self.comm_tiebreak = comm_tiebreak
        self.devices, self.device = devices, device
        self.pad_to = search_envelope(g, machine)
        self.cache: dict[bytes, float] = {}
        self.plans: dict[bytes, Plan] = {}
        self.evals = 0
        self.cache_hits = 0

    def _run(self, plans: list[Plan]) -> list[float]:
        from repro_torch.sim.batch import fixed_envelope_makespans

        g = self.g
        pad = plans + [plans[0]] * (self.batch - len(plans))
        items = [(g, p) for p in pad]
        rows = [plan_times(g, p, g.proc)[None, :] for p in pad]
        out = fixed_envelope_makespans(items, rows, self.pad_to,
                                       device=self.device,
                                       devices=self.devices)
        return [float(o[0]) for o in out[:len(plans)]]

    def score(self, genomes: list[Genome],
              extra_plans: dict[str, Plan] | None = None
              ) -> tuple[np.ndarray, dict[str, float]]:
        """Fitness per genome (+ per named raw plan), cached and deduped."""
        todo_plans: list[Plan] = []
        todo_keys: list[bytes] = []
        seen: set[bytes] = set()
        hits = 0
        for gn in genomes:
            k = gn.key()
            if k in self.cache:
                hits += 1
            elif k not in seen:
                seen.add(k)
                plan = genome_to_plan(self.g, self.machine, gn,
                                      comm_tiebreak=self.comm_tiebreak)
                todo_plans.append(plan)
                todo_keys.append(k)
                self.plans[k] = plan
            else:
                hits += 1
        self.cache_hits += hits
        if hits:
            _obs.bump("search.cache_hits", hits)
        extra_plans = extra_plans or {}
        extra_names = list(extra_plans)
        todo_plans += [extra_plans[n] for n in extra_names]
        if todo_plans:
            if len(todo_plans) > self.batch:
                raise ValueError(f"batch of {len(todo_plans)} exceeds the "
                                 f"fixed score width {self.batch}")
            fits = self._run(todo_plans)
            self.evals += len(todo_plans)
            _obs.bump("search.evals", len(todo_plans))
            for k, f in zip(todo_keys, fits[:len(todo_keys)]):
                self.cache[k] = f
            extras = dict(zip(extra_names, fits[len(todo_keys):]))
        else:
            extras = {}
        return (np.asarray([self.cache[gn.key()] for gn in genomes]),
                extras)


def _tournament(fits: np.ndarray, k: int, rng: np.random.Generator) -> int:
    cand = rng.integers(0, len(fits), size=max(1, k))
    return int(cand[np.argmin(fits[cand])])


def _ga_offspring(g, machine, pop, fits, cfg: SearchConfig,
                  rng: np.random.Generator) -> list[Genome]:
    order = np.argsort(fits, kind="stable")
    elite_n = max(1, int(cfg.pop_size * cfg.elite_frac))
    children: list[Genome] = [pop[i] for i in order[:elite_n]]
    while len(children) < cfg.pop_size:
        p1 = pop[_tournament(fits, cfg.tournament, rng)]
        p2 = pop[_tournament(fits, cfg.tournament, rng)]
        if rng.random() < cfg.cx_prob:
            perm = order_crossover(p1.perm, p2.perm, rng)
            types, widths = alloc_crossover(p1, p2, rng)
        else:
            types, widths, perm = (p1.types.copy(), p1.widths.copy(),
                                   p1.perm.copy())
        if rng.random() < cfg.mut_prob:
            types, widths = mutate_alloc(g, machine, types, widths, rng,
                                         cfg.indpb)
            perm = mutate_perm(g, perm, rng, cfg.perm_moves)
        children.append(Genome(types=types, widths=widths, perm=perm))
    return children


class _CemState:
    """Per-task categorical (type, width) + Gaussian perm-score model."""

    def __init__(self, g, machine, seeds: list[Genome]):
        n, q = g.n, g.num_types
        self.caps = width_caps(g, machine)
        wmax = int(self.caps.max())
        t_probs = np.full((n, q), 1.0 / q)
        w_probs = np.full((n, wmax), 1.0 / wmax)
        mu = np.zeros(n)
        for s in seeds:
            t_probs[np.arange(n), s.types] += 1.0
            w_probs[np.arange(n), s.widths - 1] += 1.0
            mu += -np.argsort(s.perm).astype(np.float64) / max(n, 1)
        self.t_probs = t_probs / t_probs.sum(1, keepdims=True)
        self.w_probs = w_probs / w_probs.sum(1, keepdims=True)
        self.mu = mu / max(len(seeds), 1)
        self.sigma = np.full(n, 0.5)
        self.moldable = g.speedup is not None

    def sample(self, g, rng: np.random.Generator) -> Genome:
        n = g.n
        u = rng.random((n, 1))
        types = (self.t_probs.cumsum(1) < u).sum(1).astype(np.int32)
        np.minimum(types, g.num_types - 1, out=types)
        if self.moldable:
            u = rng.random((n, 1))
            widths = 1 + (self.w_probs.cumsum(1) < u).sum(1).astype(np.int32)
            np.minimum(widths, self.caps[types].astype(np.int32), out=widths)
        else:
            widths = np.ones(n, dtype=np.int32)
        scores = self.mu + self.sigma * rng.standard_normal(n)
        return Genome(types=types, widths=widths, perm=topo_perm(g, scores))

    def refit(self, g, elite: list[Genome], alpha: float) -> None:
        n, q = g.n, g.num_types
        t_new = np.zeros_like(self.t_probs)
        w_new = np.zeros_like(self.w_probs)
        mu_new = np.zeros(n)
        for s in elite:
            t_new[np.arange(n), s.types] += 1.0
            w_new[np.arange(n), s.widths - 1] += 1.0
            mu_new += -np.argsort(s.perm).astype(np.float64) / max(n, 1)
        m = max(len(elite), 1)
        self.t_probs = (alpha * t_new / m + (1 - alpha) * self.t_probs)
        self.t_probs /= self.t_probs.sum(1, keepdims=True)
        self.w_probs = (alpha * w_new / m + (1 - alpha) * self.w_probs)
        self.w_probs /= self.w_probs.sum(1, keepdims=True)
        self.mu = alpha * mu_new / m + (1 - alpha) * self.mu
        self.sigma = np.maximum(0.05, self.sigma * 0.9)


def _mutant(g, machine, gn: Genome, cfg: SearchConfig,
            rng: np.random.Generator) -> Genome:
    types, widths = mutate_alloc(g, machine, gn.types, gn.widths, rng,
                                 cfg.indpb)
    return Genome(types=types, widths=widths,
                  perm=mutate_perm(g, gn.perm, rng, cfg.perm_moves))


def evolve_plan(g: TaskGraph, machine, config: SearchConfig | None = None,
                *, seed: int = 0, devices=None,
                device: str | torch.device = "cuda") -> SearchResult:
    """Evolve a plan for ``(g, machine)``; see the module docstring.

    Bit-reproducible: all randomness flows from one
    ``np.random.default_rng(seed)``, and the batched replay is
    deterministic — ``evolve_plan(seed=N)`` twice returns identical plans,
    fitness, and history, on the card and on the CPU alike.  ``device`` is
    where each generation is scored; ``devices`` overrides the list its
    plan axis splits over.
    """
    cfg = config or SearchConfig()
    machine = machine if isinstance(machine, Machine) \
        else Machine.from_counts(machine)
    rng = np.random.default_rng(seed)
    seeds_p = seed_plans(g, machine, comm_aware=cfg.comm_aware,
                         adapters=cfg.seed_adapters)
    scorer = _BatchScorer(g, machine, cfg.pop_size + len(seeds_p),
                          comm_tiebreak=cfg.comm_aware, devices=devices,
                          device=device)
    seed_genomes = [plan_to_genome(g, machine, p) for p in seeds_p.values()]

    # Generation 0: the seed genomes + random fill, scored alongside the
    # RAW heuristic plans — the incumbent starts at the best heuristic.
    pop = seed_genomes[:cfg.pop_size]
    while len(pop) < cfg.pop_size:
        pop.append(random_genome(g, machine, rng))
    with _obs.span("search.generation", gen=0, method=cfg.method):
        fits, seed_fitness = scorer.score(pop, extra_plans=seeds_p)
    best_key: bytes | None = None
    best_label = min(seed_fitness, key=seed_fitness.get)
    best_fit = seed_fitness[best_label]
    best_plan = seeds_p[best_label]
    best_genome = seed_genomes[list(seeds_p).index(best_label)]
    i0 = int(np.argmin(fits))
    if fits[i0] < best_fit:
        best_fit, best_genome = float(fits[i0]), pop[i0]
        best_plan, best_key = scorer.plans[pop[i0].key()], pop[i0].key()
    gen0_best = best_fit
    history = [best_fit]
    _obs.set_gauge("search.best_fitness", best_fit)

    cem = _CemState(g, machine, seed_genomes) if cfg.method == "cem" else None
    temp = cfg.sa_temp * max(gen0_best, 1e-12)

    for gen in range(1, cfg.generations + 1):
        with _obs.span("search.generation", gen=gen, method=cfg.method):
            if cfg.method == "ga":
                pop = _ga_offspring(g, machine, pop, fits, cfg, rng)
                fits, _ = scorer.score(pop)
            elif cfg.method == "cem":
                pop = [best_genome] + [cem.sample(g, rng)
                                       for _ in range(cfg.pop_size - 1)]
                fits, _ = scorer.score(pop)
                order = np.argsort(fits, kind="stable")
                elite_n = max(1, int(cfg.pop_size * cfg.elite_frac))
                cem.refit(g, [pop[i] for i in order[:elite_n]],
                          cfg.cem_alpha)
            else:  # sa: pop_size parallel Metropolis chains
                props = [_mutant(g, machine, gn, cfg, rng) for gn in pop]
                pfits, _ = scorer.score(props)
                accept = (pfits <= fits) | (
                    rng.random(cfg.pop_size)
                    < np.exp(np.minimum(0.0, (fits - pfits)
                                        / max(temp, 1e-12))))
                pop = [p if a else s for p, s, a in zip(props, pop, accept)]
                fits = np.where(accept, pfits, fits)
                temp *= cfg.sa_decay
            i = int(np.argmin(fits))
            if fits[i] < best_fit:
                best_fit, best_genome = float(fits[i]), pop[i]
                best_plan = scorer.plans[pop[i].key()]
                best_key = pop[i].key()
            history.append(best_fit)
            _obs.set_gauge("search.best_fitness", best_fit)

    _record_winner(g, cfg, best_plan, best_genome,
                   source=("genome" if best_key is not None
                           else f"seed:{best_label}"))
    return SearchResult(plan=best_plan, fitness=best_fit, genome=best_genome,
                        history=history, gen0_best=gen0_best,
                        seed_fitness=seed_fitness, evals=scorer.evals,
                        cache_hits=scorer.cache_hits, method=cfg.method)


def _record_winner(g: TaskGraph, cfg: SearchConfig, plan: Plan,
                   genome: Genome, source: str) -> None:
    """DecisionRecord provenance for the winning genome (obs-enabled
    only): each task's (type, width), its slot in the priority
    permutation, and the comm price its allocation pays."""
    if not _obs.enabled():
        return
    from repro_torch.core.allocation import task_comm_price
    from repro_torch.obs import DecisionRecord

    paid = (task_comm_price(g, plan.alloc, direction="both")
            if g.num_edges else np.zeros(g.n))
    pos = np.empty(g.n, dtype=np.int64)
    pos[genome.perm] = np.arange(g.n)
    for j in range(g.n):
        _obs.record_decision(DecisionRecord(
            scheduler=f"evo:{cfg.method}", task=j,
            rtype=int(plan.alloc[j]),
            width=1 if plan.width is None else int(plan.width[j]),
            x_frac=None, tie_break=f"perm:{int(pos[j])}",
            rule=source, comm_price=float(paid[j]), priced_comm=0.0))


def brute_force_gap(result: SearchResult, g: TaskGraph, machine) -> float:
    """Evolved-over-optimal ratio against the branch-and-bound oracle
    (small n only) — 1.0 means the search found the optimum."""
    from repro_torch.core.bruteforce import brute_force_schedule

    opt = brute_force_schedule(g, machine).makespan
    return result.fitness / max(opt, 1e-12)
