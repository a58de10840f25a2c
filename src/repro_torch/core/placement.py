"""Hetero-fleet placement planner — the paper's two-phase method applied to
model-layer DAGs.

Given a ``ModelConfig`` we extract the per-layer task graph (attention / FFN /
MoE / SSD blocks with analytic FLOPs + bytes) and a platform of Q pod types
(each with peak FLOP/s and HBM bandwidth); per-type processing times come
from each task's roofline time max(flops/peak, bytes/bw).  QHLP allocates
tasks to pod types (LP + rounding, paper §5) and OLS orders them — yielding a
stage assignment for heterogeneous pipelines (e.g. v5e pods + older pods +
CPU hosts) with the paper's Q(Q+1) guarantee against the LP bound.

A copy of the JAX package's ``repro.core.placement`` over the port's
``configs`` and ``core`` (the port imports nothing of it); host only.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dag import TaskGraph
from repro_torch.core.hlp import solve_hlp, solve_qhlp
from repro_torch.core.listsched import Schedule, hlp_ols


@dataclasses.dataclass(frozen=True)
class PodType:
    name: str
    count: int
    peak_flops: float       # per pod
    hbm_bw: float           # per pod


def _layer_tasks(cfg: ModelConfig, seq: int, batch: int):
    """(name, flops, bytes) per transformer-block sub-task."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    toks = seq * batch
    tasks = []
    for i in range(cfg.num_layers):
        if cfg.is_attn_layer(i):
            qkvo = 2 * toks * d * (cfg.num_heads + 2 * cfg.num_kv_heads +
                                   cfg.num_heads) * hd
            attn = 2 * toks * seq * cfg.num_heads * hd
            tasks.append((f"attn_{i}", qkvo + attn,
                          toks * d * 6 + 2 * seq * seq * cfg.num_heads))
        else:
            di, ns = cfg.ssm_d_inner, cfg.ssm_state
            fl = 2 * toks * d * (2 * di + 2 * ns) + toks * di * ns * 4
            tasks.append((f"ssd_{i}", fl, toks * (d + di) * 4))
        if cfg.is_moe_layer(i):
            fl = 2 * toks * d * cfg.moe_ff * 3 * cfg.moe_top_k
            by = toks * d * 4 + 3 * d * cfg.moe_ff * cfg.moe_num_experts * 2
            tasks.append((f"moe_{i}", fl, by))
        elif cfg.d_ff:
            tasks.append((f"mlp_{i}", 2 * toks * d * cfg.d_ff * 3,
                          toks * (d + cfg.d_ff) * 2 + 3 * d * cfg.d_ff * 2))
    tasks.append(("lm_head", 2 * toks * d * cfg.vocab_size,
                  toks * d * 2 + d * cfg.vocab_size * 2))
    return tasks


def layer_dag(cfg: ModelConfig, pods: list[PodType], *, seq: int = 4096,
              batch: int = 8, streams: int = 1) -> TaskGraph:
    """Layer DAG with per-pod-type roofline processing times.

    ``streams`` parallel microbatch chains share nothing until a final
    all-reduce barrier task — the planner must split them across pod types
    (a chain has no intra-parallelism, so one stream == one busy pod)."""
    base = _layer_tasks(cfg, seq, batch)
    names, flops, bytes_ = [], [], []
    edges = []
    for s in range(streams):
        off = len(names)
        for (nm, fl, by) in base:
            names.append(f"s{s}/{nm}")
            flops.append(fl)
            bytes_.append(by)
        edges.extend((off + i, off + i + 1) for i in range(len(base) - 1))
    if streams > 1:  # gradient/all-reduce barrier joining the streams
        j = len(names)
        names.append("allreduce")
        flops.append(base[-1][1] * 0.01)
        bytes_.append(base[-1][2])
        edges.extend((s * len(base) + len(base) - 1, j)
                     for s in range(streams))
    proc = np.zeros((len(names), len(pods)))
    for jj, (fl, by) in enumerate(zip(flops, bytes_)):
        for q, pod in enumerate(pods):
            proc[jj, q] = max(fl / pod.peak_flops, by / pod.hbm_bw)
    return TaskGraph.build(proc, edges, names=names)


@dataclasses.dataclass
class PipelinePlan:
    assignment: np.ndarray      # task -> pod type
    schedule: Schedule
    lp_bound: float
    pods: list[PodType]
    names: tuple[str, ...]

    @property
    def makespan(self) -> float:
        return self.schedule.makespan

    def summary(self) -> str:
        lines = [f"pipeline plan over {[p.name for p in self.pods]}: "
                 f"makespan={self.makespan:.4f}s  LP*={self.lp_bound:.4f}s  "
                 f"ratio={self.makespan / self.lp_bound:.3f}"]
        for q, pod in enumerate(self.pods):
            sel = [self.names[i] for i in np.flatnonzero(self.assignment == q)]
            lines.append(f"  {pod.name}: {len(sel)} tasks "
                         f"({', '.join(sel[:6])}{'...' if len(sel) > 6 else ''})")
        return "\n".join(lines)


def plan_pipeline(cfg: ModelConfig, pods: list[PodType], *, seq: int = 4096,
                  batch: int = 8, streams: int = 1) -> PipelinePlan:
    """HLP/QHLP allocation + OLS scheduling of the layer DAG onto pod types."""
    g = layer_dag(cfg, pods, seq=seq, batch=batch, streams=streams)
    counts = [p.count for p in pods]
    if len(pods) == 2:
        sol = solve_hlp(g, counts[0], counts[1])
    else:
        sol = solve_qhlp(g, counts)
    sched = hlp_ols(g, counts, sol.alloc)
    sched.validate(g, counts)
    return PipelinePlan(assignment=sol.alloc, schedule=sched,
                        lp_bound=sol.lp_value, pods=pods, names=g.names)
