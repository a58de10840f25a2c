"""repro_torch.sim — discrete-event scheduler simulation over one protocol.

The port's copy of the JAX package's ``repro.sim`` host layer.  The paper's
experimental section (§6) is a large simulation campaign: run every
algorithm (HLP-EST/OLS, HEFT, ER-LS, greedy rules, …) over libraries of
task graphs and machine configurations, and compare makespans against the
LP lower bound.  This package unifies them behind one ``Scheduler``
protocol and one event-driven engine, built on the allocation API of
``repro_torch.platform``:

  * **machines are ``Platform`` objects** — typed pools with canonical
    names and counts.  ``Machine`` is the simulation-facing subclass;
    bare ``counts`` lists still work through a deprecation shim.
  * **decisions are ``Decision`` records** — an allocation is
    ``(type, width)``.  On *moldable* graphs (``TaskGraph.speedup``
    curves) a width-w task claims w units of one pool and shrinks by its
    curve; ``width=1`` is the paper's rigid model.
  * **stochastic runtimes** — the engine perturbs ``proc`` with a seeded
    ``NoiseModel`` and replays static plans dynamically;
  * **communication costs and network models** — ``instant``,
    ``fixed_latency`` and ``maxmin_fair`` (``repro_torch.sim.network``);
  * **scenario families** — ``repro_torch.sim.scenarios``.

The batched replay evaluator (``repro_torch.sim.batch``) replays a whole
(scenario × scheduler × seed) grid with one launch of a CUDA kernel per
shape bucket, and prices ``maxmin_fair`` contention with one launch of the
contention kernel per padded shape (``set_contention_kernel("numpy")``
routes through the per-plan oracle instead).  Not yet ported: the
pipelined campaign executor (``repro.sim.pipeline``) and the split of the
plan axis over several cards.

Entry points::

    from repro_torch.sim import simulate, make_scheduler, ADAPTERS
    from repro_torch.sim.scenarios import default_suite

    for sc in default_suite(seed=0):
        for name in ADAPTERS:
            r = simulate(sc.graph, sc.machine, make_scheduler(name),
                         noise=NoiseModel("lognormal", 0.1), seed=sc.seed)
            print(sc.name, name, r.makespan)
"""
from repro_torch.platform import Decision, Platform

from .adapters import ADAPTERS, FrozenPlanScheduler, make_scheduler, plan_for
from .batch import reset_trace_counts, trace_count
from .engine import (Machine, MachineState, NoiseModel, Plan, Scheduler,
                     SimResult, TraceEvent, plan_times, simulate)
from .network import (NETWORKS, FixedLatencyNetwork, InstantNetwork,
                      MaxMinFairNetwork, NetworkModel, contention_kernel,
                      make_network, set_contention_kernel)
from .scenarios import (SCENARIO_FAMILIES, Scenario, default_suite,
                        from_estee, make_scenario, moldable_suite, to_estee)

__all__ = [
    "ADAPTERS", "FrozenPlanScheduler", "make_scheduler", "plan_for",
    "reset_trace_counts", "trace_count",
    "Decision", "Platform", "Machine", "MachineState", "NoiseModel", "Plan",
    "Scheduler", "SimResult", "TraceEvent", "plan_times", "simulate",
    "NETWORKS", "NetworkModel", "InstantNetwork", "FixedLatencyNetwork",
    "MaxMinFairNetwork", "contention_kernel", "make_network",
    "set_contention_kernel",
    "SCENARIO_FAMILIES", "Scenario", "default_suite", "from_estee",
    "make_scenario", "moldable_suite", "to_estee",
]
