"""repro_torch.search — population-based plan search on the bucketed
evaluator: the port of the JAX package's ``repro.search``.

A genome pairs an allocation vector of ``Decision=(type, width)`` per task
with a priority permutation; :func:`evolve_plan` evolves a population of
them (GA, CEM or simulated annealing behind one :class:`SearchConfig`),
scoring every generation as a single fixed-shape batch through the
``repro_torch.sim`` bucketed replay — one launch of the replay kernel a
generation on the card, one replay shape for the whole search.
Generation 0 is seeded with the canonical-rounded LP plan, HEFT and ER-LS,
so the result is anytime-no-worse than the best existing heuristic.
"""
from .evolve import (METHODS, SearchConfig, SearchResult, brute_force_gap,
                     evolve_plan)
from .genome import (Genome, alloc_crossover, genome_to_plan, is_topo_perm,
                     lp_seed_plan, mutate_alloc, mutate_perm, order_crossover,
                     plan_to_genome, random_genome, seed_plans, topo_perm,
                     width_caps)

__all__ = [
    "METHODS",
    "Genome",
    "SearchConfig",
    "SearchResult",
    "alloc_crossover",
    "brute_force_gap",
    "evolve_plan",
    "genome_to_plan",
    "is_topo_perm",
    "lp_seed_plan",
    "mutate_alloc",
    "mutate_perm",
    "order_crossover",
    "plan_to_genome",
    "random_genome",
    "seed_plans",
    "topo_perm",
    "width_caps",
]
