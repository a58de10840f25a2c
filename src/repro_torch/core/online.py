"""On-line allocation rules (paper §4.2): greedy rules R1–R3 and ER-LS.

Tasks arrive one by one in an order respecting the precedences; the scheduler
takes an *irrevocable* (allocation + processor + start time) decision at
arrival, knowing only the tasks seen so far and the committed schedule.

ER-LS (Enhanced Rules – List Scheduling), the paper's contribution:
  Step 1: if p̄_j >= R_{j,gpu} + p_j  -> GPU side
          (R_{j,gpu} = max(τ_gpu, max_{i∈Γ⁻(j)} C_i), τ_gpu = earliest idle GPU)
  Step 2: otherwise rule R2: CPU iff p̄_j/√m <= p_j/√k.
Competitive ratio: at most 4√(m/k) (Thm 3), at least √(m/k) (Thm 4).

The whole-graph policies (``er_ls``, ``eft_online``, the moldable rule) port
with the simulation slice; the serving dispatcher needs only the per-task
decision.
"""
from __future__ import annotations

import numpy as np

from .dag import CPU, GPU


def rule_r1(pc: float, pg: float, m: int, k: int) -> int:
    return CPU if pc / m <= pg / k else GPU


def rule_r2(pc: float, pg: float, m: int, k: int) -> int:
    return CPU if pc / np.sqrt(m) <= pg / np.sqrt(k) else GPU


def rule_r3(pc: float, pg: float, m: int, k: int) -> int:
    return CPU if pc <= pg else GPU


RULES = {"R1": rule_r1, "R2": rule_r2, "R3": rule_r3}


def erls_decide(pc: float, pg: float, m: int, k: int, r_gpu: float) -> int:
    """The ER-LS allocation decision for one arriving task.

    ``r_gpu`` is the task's earliest possible start on the GPU side
    (max of earliest idle GPU and the task's ready time).
    """
    if pc >= r_gpu + pg:                           # Step 1
        return GPU
    return rule_r2(pc, pg, m, k)                   # Step 2
