# The paper's primary contribution: two-phase (allocation, scheduling) for
# heterogeneous platforms — HLP/QHLP allocation LPs (exact + JAX-native),
# List-Scheduling variants (EST/OLS/HEFT), and the on-line ER-LS algorithm.
# The allocation API is v2: machines are `repro_torch.platform.Platform` objects
# (bare counts lists still accepted via a deprecation shim) and decisions
# are `(type, width)` `Decision` records — moldable tasks carry speedup
# curves (`TaskGraph.speedup`) solved by the width-indexed MHLP relaxation.
from .allocation import AllocationProblem, frac_objective
from .bruteforce import brute_force_opt, brute_force_schedule
from .dag import (CPU, GPU, TaskGraph, amdahl_speedup, powerlaw_speedup,
                  validate_speedup)
from .hlp import (HLPSolution, canonical_round_moldable, lp_lower_bound,
                  mhlp_choices, solve_hlp, solve_mhlp, solve_qhlp)
from .listsched import Schedule, heft, hlp_est, hlp_ols, list_schedule, ols_rank
from .online import (decide_eft, decide_erls, er_ls, eft_online,
                     efficient_width, erls_decide, erls_decide_moldable,
                     greedy_online, random_online, RULES)
from .theory import makespan_lower_bound

__all__ = [
    "AllocationProblem", "frac_objective",
    "CPU", "GPU", "TaskGraph", "amdahl_speedup", "powerlaw_speedup",
    "validate_speedup", "HLPSolution", "lp_lower_bound", "solve_hlp",
    "solve_qhlp", "solve_mhlp", "mhlp_choices", "canonical_round_moldable",
    "Schedule", "heft", "hlp_est", "hlp_ols", "list_schedule",
    "ols_rank", "er_ls", "eft_online", "erls_decide", "erls_decide_moldable",
    "efficient_width", "decide_eft", "decide_erls", "greedy_online",
    "random_online", "RULES",
    "brute_force_opt", "brute_force_schedule", "makespan_lower_bound",
]
